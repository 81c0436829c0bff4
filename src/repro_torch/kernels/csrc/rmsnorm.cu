// Fused RMSNorm for sm_90a:
//   y = x · rsqrt(mean(x²) + eps) · (1 + scale),
// x [M, D] float32 or bfloat16, scale float32 [D], y [M, D] in x's type; the
// arithmetic is float32 whatever x's type, with one rounding to x's type.
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
// Here one warp owns one row, eight rows to a block of 256 threads, and the
// row moves in 16-byte vectors (8 bf16 or 4 float32 values a lane): the
// lanes stride over the row's vectors, keep them in registers while a
// shuffle tree sums x² in float32, then scale and write them — x is read
// from memory once.  `rmsnorm_vec<T, VEC>` holds up to VEC vectors a lane;
// the launcher picks the smallest compiled VEC that covers the row (bf16
// D = 2560 is 320 vectors: VEC = 10), so every config width (2048 to 5120,
// and up to 10240 bf16 / 5120 float32) takes it.  Each block first stages
// (1 + scale) in shared memory as float32, read as float4 vectors once per
// block.  Rows whose width is not a multiple of the vector, bases that are
// not 16-byte aligned and wider rows take `rmsnorm_scalar`: scalar loads,
// a second pass over the row from L1/L2.  No atomics: a row's sum has one
// fixed order, so the result is deterministic.  The mean is the sum divided
// by D and the scale is applied as (x·r)·(1 + scale), in the plain
// version's order; rsqrtf differs from the plain version's rsqrt by at most
// 2 ulp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define ROWS_PER_BLOCK (THREADS / 32)
#define MAX_VEC 40

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One 16-byte vector as float32 values and back.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int PER = 4;
  __device__ static void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int PER = 8;
  __device__ static void unpack(const uint4& u, float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t two(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  __device__ static uint4 pack(const float (&f)[8]) {
    return make_uint4(two(f[0], f[1]), two(f[2], f[3]), two(f[4], f[5]),
                      two(f[6], f[7]));
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_vec(const T* __restrict__ x, const float* __restrict__ scale,
                T* __restrict__ out, long long m, int d, float eps) {
  constexpr int PER = Vec<T>::PER;
  extern __shared__ float4 w4[];   // 1 + scale
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  for (int i = threadIdx.x; i < d / 4; i += THREADS) {
    const float4 s = s4[i];
    w4[i] = make_float4(1.0f + s.x, 1.0f + s.y, 1.0f + s.z, 1.0f + s.w);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= m) return;
  const int nv = d / PER;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* yr = reinterpret_cast<uint4*>(out + row * d);
  uint4 r[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    if (lane + 32 * i < nv) r[i] = __ldg(xr + lane + 32 * i);
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if (lane + 32 * i < nv) {
      float f[PER];
      Vec<T>::unpack(r[i], f);
#pragma unroll
      for (int e = 0; e < PER; ++e) ss = fmaf(f[e], f[e], ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float rs = rsqrtf(ss / (float)d + eps);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = lane + 32 * i;
    if (c < nv) {
      float f[PER];
      Vec<T>::unpack(r[i], f);
#pragma unroll
      for (int j = 0; j < PER / 4; ++j) {
        const float4 w = w4[c * (PER / 4) + j];
        f[4 * j] = (f[4 * j] * rs) * w.x;
        f[4 * j + 1] = (f[4 * j + 1] * rs) * w.y;
        f[4 * j + 2] = (f[4 * j + 2] * rs) * w.z;
        f[4 * j + 3] = (f[4 * j + 3] * rs) * w.w;
      }
      yr[c] = Vec<T>::pack(f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_scalar(const T* __restrict__ x, const float* __restrict__ scale,
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

template <typename T>
static void launch_t(const void* x, const void* scale, void* out, long long m,
                     int d, float eps, unsigned int blocks, cudaStream_t s) {
  constexpr int PER = Vec<T>::PER;
  const bool aligned = ((unsigned long long)x | (unsigned long long)out |
                        (unsigned long long)scale) % 16 == 0;
  const int need = (d / PER + 31) / 32;   // vectors a lane
  const T* xt = (const T*)x;
  const float* st = (const float*)scale;
  T* yt = (T*)out;
  const int smem = d * (int)sizeof(float);
  if (aligned && d % PER == 0 && need <= MAX_VEC) {
#define VEC_CASE(V)                                                       \
  if (need <= V) {                                                        \
    rmsnorm_vec<T, V><<<blocks, THREADS, smem, s>>>(xt, st, yt, m, d, eps); \
    return;                                                               \
  }
    VEC_CASE(1)
    VEC_CASE(2)
    VEC_CASE(4)
    VEC_CASE(8)
    VEC_CASE(10)
    VEC_CASE(12)
    VEC_CASE(16)
    VEC_CASE(20)
    VEC_CASE(24)
    VEC_CASE(32)
    VEC_CASE(40)
#undef VEC_CASE
  }
  rmsnorm_scalar<T><<<blocks, THREADS, 0, s>>>(xt, st, yt, m, d, eps);
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
  if (bf16)
    launch_t<__nv_bfloat16>(x, scale, out, m, d, eps, (unsigned int)blocks, s);
  else
    launch_t<float>(x, scale, out, m, d, eps, (unsigned int)blocks, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
