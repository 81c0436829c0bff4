// ELL scatter u = Φᵀ v for sm_90a:  u[cols[m,k], r] += vals[m,k]·v[m, r].
//
// Replaces the TPU kernel src/repro/kernels/ell_spmv/ell_spmv_t.py:48
// `ell_spmv_t` (pallas_call at :80, body `_spmv_t_kernel` :31).  Plain
// version: repro_torch/kernels/ell_spmv/ref.py `ell_spmv_t_ref`.
//
// What bounds it on this card: bytes — the N·R·4-byte output, which has to
// be zeroed and written once (64 MB at N = 10⁶, R = 16), against a small
// payload on the main path (the T = 1024 training rows).  The TPU kernel
// kept the whole output resident in VMEM across its sequential grid; SMs run
// in parallel in no order, so the scatter here is a float atomicAdd into the
// output, which the wrapper zeroes (torch.zeros) before the launch.
//
// Design: one thread per (row m, slot k, column r), r fastest, so the R
// atomics of one slot hit one contiguous run of u.  A slot whose product is
// exactly ±0 (a halted walker) is skipped: adding a zero never changes a
// float sum that starts at +0.  The summation order of the atomics changes
// from run to run, so results agree with the plain version to float32
// rounding, not bit for bit.
#include <cuda_runtime.h>

__global__ void ell_spmv_t_kernel(const float* __restrict__ vals,
                                  const int* __restrict__ cols,
                                  const float* __restrict__ v,
                                  float* __restrict__ out, long long m_rows,
                                  int k, int r) {
  const long long total = m_rows * k * r;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const long long mk = i / r;
    const int c = (int)(i - mk * r);
    const long long m = mk / k;
    const float contrib = vals[mk] * v[m * r + c];
    if (contrib != 0.0f) atomicAdd(out + (long long)cols[mk] * r + c, contrib);
  }
}

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int ell_spmv_t_launch(const void* vals, const void* cols, const void* v,
                      void* out, long long m_rows, int k, int r, void* stream) {
  const long long total = m_rows * k * r;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride beyond this
  ell_spmv_t_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)vals, (const int*)cols, (const float*)v, (float*)out, m_rows,
      k, r);
  return (int)cudaGetLastError();
}

}  // extern "C"
