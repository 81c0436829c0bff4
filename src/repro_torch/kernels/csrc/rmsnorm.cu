// Fused RMSNorm for sm_90a:
//   y = x · rsqrt(mean(x²) + eps) · (1 + scale),
// x [M, D] float32 or bfloat16, scale float32 [D], y [M, D] in x's type; the
// arithmetic is float32 whatever x's type.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py:27 `rmsnorm`
// (pallas_call at :42, body `_rmsnorm_kernel` :17).  Plain version:
// repro_torch/kernels/rmsnorm/ref.py `rmsnorm_ref`.
//
// What bounds it on this card: bytes.  The function reads x once and writes
// y once, 2·M·D·sizeof(x) bytes plus the scale (14 µs at [4608, 2560] bf16 at
// 3.35 TB/s), against 4·M·D float32 operations (0.7 µs at 67 TFLOP/s).
//
// Design.  The TPU kernel staged a [256, D] row tile in VMEM per grid step.
// Here one warp owns one row: its lanes stride over the row summing x² in
// float32, a shuffle tree gives every lane the sum, and a second pass over
// the row (from L1/L2: a row is at most a few KB) writes y with one rounding
// to x's type.  Eight rows per block of 256 threads, any M, any D ≥ 1.  No
// shared memory, no atomics: a row's sum has one fixed order, so the result
// is deterministic.  The mean is the sum divided by D and the scale is
// applied as (x·r)·(1 + scale), in the plain version's order; rsqrtf differs
// from the plain version's rsqrt by at most 2 ulp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define THREADS 256
#define ROWS_PER_BLOCK (THREADS / 32)

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, long long m, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= m) return;
  const T* xr = x + row * d;
  T* yr = out + row * d;
  float ss = 0.0f;
  for (int j = lane; j < d; j += 32) {
    const float v = load_f(xr + j);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)d + eps);
  for (int j = lane; j < d; j += 32) {
    store_f(yr + j, (load_f(xr + j) * r) * (1.0f + scale[j]));
  }
}

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x, out: [m, d] float32 (bf16 == 0) or bfloat16 (bf16 == 1); scale: f32[d].
int rmsnorm_launch(const void* x, const void* scale, void* out, long long m,
                   int d, float eps, int bf16, void* stream) {
  if (m == 0) return (int)cudaSuccess;
  if (m < 0 || d < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (m + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    rmsnorm_kernel<__nv_bfloat16><<<(unsigned int)blocks, THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)scale, (__nv_bfloat16*)out, m, d, eps);
  } else {
    rmsnorm_kernel<float><<<(unsigned int)blocks, THREADS, 0, s>>>(
        (const float*)x, (const float*)scale, (float*)out, m, d, eps);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
