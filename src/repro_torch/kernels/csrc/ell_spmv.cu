// ELL gather-reduce y = Φ u for sm_90a:  y[m, r] = Σ_k vals[m,k]·u[cols[m,k], r].
//
// Replaces the TPU kernel src/repro/kernels/ell_spmv/ell_spmv.py:42
// `ell_spmv` (pallas_call at :77, body `_spmv_kernel` :28).  Plain version:
// repro_torch/kernels/ell_spmv/ref.py `ell_spmv_ref`.
//
// What bounds it on this card: bytes.  It does 2 flops per 8 payload bytes
// (vals + cols) plus a random gather of u; the payload is read once and the
// output written once, so the least time is (M·K·8 + N·R·4 + M·R·4) / HBM
// rate.  The TPU kernel kept all of u resident in VMEM; here u stays in
// global memory and the gathers are served from L2 (u is 4·N·R bytes:
// 4 MB at N = 10⁶, R = 1; 64 MB at R = 16).
//
// Design: one thread per output element (row m, column r), r fastest, so
// the R threads of a row read one contiguous R-float row of u per slot and
// the payload row once through L1.  Sums run over k in order, in float32.
#include <cuda_runtime.h>

__global__ void ell_spmv_kernel(const float* __restrict__ vals,
                                const int* __restrict__ cols,
                                const float* __restrict__ u,
                                float* __restrict__ y, long long m_rows, int k,
                                int r) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= m_rows * r) return;
  const long long m = tid / r;
  const int c = (int)(tid - m * r);
  const float* vrow = vals + m * k;
  const int* crow = cols + m * k;
  float acc = 0.0f;
  for (int j = 0; j < k; ++j) acc += vrow[j] * u[(long long)crow[j] * r + c];
  y[tid] = acc;
}

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int ell_spmv_launch(const void* vals, const void* cols, const void* u, void* y,
                    long long m_rows, int k, int r, void* stream) {
  const long long total = m_rows * r;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  ell_spmv_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)vals, (const int*)cols, (const float*)u, (float*)y, m_rows,
      k, r);
  return (int)cudaGetLastError();
}

}  // extern "C"
