// Fused K̂ matvec y = Φ_rows (Φ_colsᵀ v) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ell_spmv/khat_fused.py:83
// `khat_matvec_fused` (pallas_call at :126, body `_khat_kernel` :34).  Plain
// version: repro_torch/kernels/ell_spmv/ref.py `khat_matvec_ref`.
//
// What bounds it on this card: bytes.  Square training-block solve (every CG
// matvec of H = K̂_xx + σ²I): the payload is T·K·8 bytes (≈0.4 MB at T = 1024,
// K = 48) but the N-long intermediate u has to be zeroed first — N·R·4 bytes
// (64 MB at N = 10⁶, R = 16), so the zeroing, not the payload, sets the time.
// Cross form K̂_{·x}α over all N rows: the N·K·8-byte row payload dominates.
// The TPU kernel kept u in 16 MB of VMEM across a sequential (phase, block)
// grid; an SM has 227 KB, so u lives in a global scratch buffer here and is
// kept in the 50 MB L2 where it fits.
//
// Design: ONE cooperative launch (cudaLaunchCooperativeKernel) whose grid is
// the number of blocks that can be resident at once (occupancy × SMs), with
// grid-stride loops and cooperative_groups grid.sync() between
//   phase 0  zero u                      (N·R floats),
//   phase 1  scatter vals_c·v into u     (float atomicAdd, ±0 skipped),
//   phase 2  gather y = Σ_k vals_r·u[cols_r]  (one thread per (row, r)).
// One launch keeps the phases back to back with u hot in L2 and costs one
// launch latency per CG iteration instead of three.  bf16 payloads are
// upcast with __bfloat162float; all arithmetic and u are float32.  The
// scatter's atomics sum in an order that changes from run to run, so results
// agree with the plain version to float32 rounding, not bit for bit.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void khat_fused_kernel(const T* __restrict__ vals_r,
                                  const int* __restrict__ cols_r,
                                  const T* __restrict__ vals_c,
                                  const int* __restrict__ cols_c,
                                  const float* __restrict__ v,
                                  float* __restrict__ u, float* __restrict__ y,
                                  long long m_r, int k_r, long long m_c, int k_c,
                                  long long n_nodes, int r) {
  cg::grid_group grid = cg::this_grid();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;

  for (long long i = t0; i < n_nodes * r; i += stride) u[i] = 0.0f;
  grid.sync();

  for (long long i = t0; i < m_c * k_c * r; i += stride) {
    const long long mk = i / r;
    const int c = (int)(i - mk * r);
    const long long m = mk / k_c;
    const float contrib = to_f32(vals_c[mk]) * v[m * r + c];
    if (contrib != 0.0f) atomicAdd(u + (long long)cols_c[mk] * r + c, contrib);
  }
  grid.sync();

  for (long long i = t0; i < m_r * r; i += stride) {
    const long long m = i / r;
    const int c = (int)(i - m * r);
    const T* vrow = vals_r + m * k_r;
    const int* crow = cols_r + m * k_r;
    float acc = 0.0f;
    for (int j = 0; j < k_r; ++j)
      acc += to_f32(vrow[j]) * u[(long long)crow[j] * r + c];
    y[i] = acc;
  }
}

template <typename T>
static int launch(const void* vals_r, const void* cols_r, const void* vals_c,
                  const void* cols_c, const void* v, void* u, void* y,
                  long long m_r, int k_r, long long m_c, int k_c,
                  long long n_nodes, int r, void* stream) {
  const int threads = 256;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, khat_fused_kernel<T>, threads, 0);
  if (err != cudaSuccess) return (int)err;
  long long want = n_nodes * r;
  if (m_c * k_c * r > want) want = m_c * k_c * r;
  if (m_r * r > want) want = m_r * r;
  long long blocks = (want + threads - 1) / threads;
  const long long resident = (long long)per_sm * sms;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;

  const T* a0 = (const T*)vals_r;
  const int* a1 = (const int*)cols_r;
  const T* a2 = (const T*)vals_c;
  const int* a3 = (const int*)cols_c;
  const float* a4 = (const float*)v;
  float* a5 = (float*)u;
  float* a6 = (float*)y;
  void* args[] = {(void*)&a0, (void*)&a1, (void*)&a2,   (void*)&a3,
                  (void*)&a4, (void*)&a5, (void*)&a6,   (void*)&m_r,
                  (void*)&k_r, (void*)&m_c, (void*)&k_c, (void*)&n_nodes,
                  (void*)&r};
  err = cudaLaunchCooperativeKernel((const void*)khat_fused_kernel<T>,
                                    dim3((unsigned int)blocks), dim3(threads),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32 payloads, 1 = bfloat16 payloads (both sides).
int khat_fused_launch(const void* vals_r, const void* cols_r, const void* vals_c,
                      const void* cols_c, const void* v, void* u, void* y,
                      long long m_r, int k_r, long long m_c, int k_c,
                      long long n_nodes, int r, int dtype, void* stream) {
  if (dtype == 1)
    return launch<__nv_bfloat16>(vals_r, cols_r, vals_c, cols_c, v, u, y, m_r,
                                 k_r, m_c, k_c, n_nodes, r, stream);
  return launch<float>(vals_r, cols_r, vals_c, cols_c, v, u, y, m_r, k_r, m_c,
                       k_c, n_nodes, r, stream);
}

}  // extern "C"
