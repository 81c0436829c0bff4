// FlashAttention-2 forward for sm_90a: online softmax over KV tiles, GQA
// (kv head = q head // (H / Hkv)), causal and sliding-window masks, a
// kv-length mask, an optional tanh logit softcap, and rows that see no key
// written as 0.
//   q [B, H, Sq, D], k/v [B, Hkv, Skv, D], o [B, H, Sq, D]; float32 or
//   bfloat16 in (all three alike), float32 arithmetic, o in the input type.
// Each tensor is addressed through its own batch, head and sequence strides;
// the head dim must be contiguous.  Any D from 1 to 320.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py:104
// `flash_attention` (pallas_call at :150, body `_flash_kernel` :32).  Plain
// version: repro_torch/kernels/flash_attention/ref.py `mha_ref`.
//
// What bounds it on this card: operations.  At the LM path's prefill shape,
// [1, 32, 4608, 80] q and [1, 8, 4608, 80] k/v in bf16, causal with window
// 4096, the unmasked (query, key) pairs are 10,487,808 per head, and the work
// is 4·D·H·pairs ≈ 107.4 GFLOP: 0.109 ms at the bf16 tensor-core rate (989
// TFLOP/s) and 1.60 ms at the float32 CUDA-core rate (67 TFLOP/s).  The bytes
// (q, k, v read once, o written once) are 59 MB, 17.6 µs at 3.35 TB/s.  This
// kernel does its arithmetic in float32 on the CUDA cores, so the float32
// bound is the one it can approach; the tensor-core bound is the redesign's.
//
// Design.  The TPU kernel ran a (B·H, q tile, kv tile) grid whose third axis
// was sequential on one core, carrying (m, l, acc) in VMEM scratch.  Here one
// block of 256 threads owns one (batch·head, q tile) pair and loops over the
// KV tiles itself: four threads share a query row, each holding a quarter of
// its head dims (16-byte chunks, interleaved so that the four read
// neighbouring words) of q and of the output accumulator in registers, with
// the row's running max m and sum l.  A KV tile of 32 keys is staged in
// shared memory as float32 (zero-padded past Skv and past D); each key's
// logit is the four partial dot products summed by two shuffles.  The online
// softmax runs over 16 keys at a time: logits (softcapped, then masked to
// -1e30), the new max, one rescale of acc and l, then p = exp(s − m) zeroed
// on masked keys and acc += p·v.  Blocks visit only the KV tiles that the
// causal and window masks leave open for some row of the q tile (the
// `pl.when` skip of the TPU kernel, :80-91), so the work follows the unmasked
// pairs.  GQA reads the group's KV head in place: no replication.  Ragged Sq
// and Skv are masked, never padded.  Threads hold two query rows each where
// D ≤ 128 (q tile 128 rows), one above (q tile 64 rows), so that each value
// read from shared memory feeds two rows where registers allow.  No tensor
// cores, no TMA, no double buffering: the simple kernel first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define THREADS 256
#define LANES 4                    // threads per query row
#define GROUPS (THREADS / LANES)   // row groups per block
#define BK 32                      // keys per shared-memory tile
#define KC 16                      // keys per online-softmax step
#define MAX_NC 20                  // 16-dim chunks: D ≤ 320
#define NEG_INF (-1e30f)

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// NC: 16-dim chunks of the padded head dim; RPT: query rows per thread.
template <typename T, int NC, int RPT>
__global__ void __launch_bounds__(THREADS)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int h, int hkv,
              int sq, int skv, int d, Strides st, int causal, int window,
              float softcap, float sm_scale) {
  constexpr int DP = 16 * NC;
  constexpr int BQ = GROUPS * RPT;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + BK * DP;

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hq = bh - b * h;
  const int hk = hq / (h / hkv);
  const T* qb = q + b * st.qb + hq * st.qh;
  const T* kb = k + b * st.kb + hk * st.kh;
  const T* vb = v + b * st.vb + hk * st.vh;
  T* ob = o + b * st.ob + hq * st.oh;

  const int lane = threadIdx.x & (LANES - 1);
  const int grp = threadIdx.x / LANES;
  const int q0 = blockIdx.x * BQ;

  int row[RPT];
  float4 qr[RPT][NC];
  float4 acc[RPT][NC];
  float m[RPT], l[RPT];
#pragma unroll
  for (int t = 0; t < RPT; ++t) {
    row[t] = q0 + grp + GROUPS * t;
    m[t] = NEG_INF;
    l[t] = 0.0f;
    const T* qrow = qb + (long long)row[t] * st.qs;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d0 = 16 * c + 4 * lane;
      float e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        e[u] = (row[t] < sq && d0 + u < d) ? load_f(qrow + d0 + u) : 0.0f;
      qr[t][c] = make_float4(e[0], e[1], e[2], e[3]);
      acc[t][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  // The KV range some row of this q tile may see.
  const int i_lo = q0;
  const int i_hi = min(q0 + BQ, sq) - 1;
  int k_begin = 0, k_end = skv;
  if (causal) k_end = min(skv, i_hi + 1);
  if (window > 0) k_begin = max(0, i_lo - window + 1);

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < BK * DP; idx += THREADS) {
      const int j = idx / DP;
      const int dim = idx - j * DP;
      const int kp = k0 + j;
      const bool in = kp < skv && dim < d;
      ks[idx] = in ? load_f(kb + (long long)kp * st.ks + dim) : 0.0f;
      vs[idx] = in ? load_f(vb + (long long)kp * st.vs + dim) : 0.0f;
    }
    __syncthreads();

#pragma unroll 1
    for (int jj = 0; jj < BK; jj += KC) {
      float s[RPT][KC];
      unsigned keep[RPT];
#pragma unroll
      for (int t = 0; t < RPT; ++t) keep[t] = 0u;
#pragma unroll
      for (int u = 0; u < KC; ++u) {
        const float4* kr = reinterpret_cast<const float4*>(ks + (jj + u) * DP) + lane;
        float part[RPT];
#pragma unroll
        for (int t = 0; t < RPT; ++t) part[t] = 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 kk = kr[4 * c];
#pragma unroll
          for (int t = 0; t < RPT; ++t) {
            part[t] = fmaf(qr[t][c].x, kk.x, part[t]);
            part[t] = fmaf(qr[t][c].y, kk.y, part[t]);
            part[t] = fmaf(qr[t][c].z, kk.z, part[t]);
            part[t] = fmaf(qr[t][c].w, kk.w, part[t]);
          }
        }
        const int kp = k0 + jj + u;
#pragma unroll
        for (int t = 0; t < RPT; ++t) {
          float sv = part[t] + __shfl_xor_sync(0xffffffffu, part[t], 1);
          sv += __shfl_xor_sync(0xffffffffu, sv, 2);
          sv *= sm_scale;
          if (softcap > 0.0f) sv = softcap * tanhf(sv / softcap);
          const int i = row[t];
          const bool ok = kp < skv && (!causal || kp <= i) &&
                          (window <= 0 || kp > i - window);
          s[t][u] = ok ? sv : NEG_INF;
          keep[t] |= (unsigned)ok << u;
        }
      }
#pragma unroll
      for (int t = 0; t < RPT; ++t) {
        float mx = m[t];
#pragma unroll
        for (int u = 0; u < KC; ++u) mx = fmaxf(mx, s[t][u]);
        const float alpha = expf(m[t] - mx);
        float psum = 0.0f;
#pragma unroll
        for (int u = 0; u < KC; ++u) {
          const float p = ((keep[t] >> u) & 1u) ? expf(s[t][u] - mx) : 0.0f;
          s[t][u] = p;
          psum += p;
        }
        l[t] = l[t] * alpha + psum;
        m[t] = mx;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[t][c].x *= alpha;
          acc[t][c].y *= alpha;
          acc[t][c].z *= alpha;
          acc[t][c].w *= alpha;
        }
      }
#pragma unroll
      for (int u = 0; u < KC; ++u) {
        const float4* vr = reinterpret_cast<const float4*>(vs + (jj + u) * DP) + lane;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = vr[4 * c];
#pragma unroll
          for (int t = 0; t < RPT; ++t) {
            acc[t][c].x = fmaf(s[t][u], vv.x, acc[t][c].x);
            acc[t][c].y = fmaf(s[t][u], vv.y, acc[t][c].y);
            acc[t][c].z = fmaf(s[t][u], vv.z, acc[t][c].z);
            acc[t][c].w = fmaf(s[t][u], vv.w, acc[t][c].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < RPT; ++t) {
    if (row[t] >= sq) continue;
    const float safe = l[t] == 0.0f ? 1.0f : l[t];
    T* orow = ob + (long long)row[t] * st.os;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d0 = 16 * c + 4 * lane;
      const float e[4] = {acc[t][c].x, acc[t][c].y, acc[t][c].z, acc[t][c].w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (d0 + u < d) store_f(orow + d0 + u, e[u] / safe);
    }
  }
}

template <typename T, int NC>
static int launch_nc(const void* q, const void* k, const void* v, void* o,
                     int b, int h, int hkv, int sq, int skv, int d,
                     const Strides& st, int causal, int window, float softcap,
                     float sm_scale, cudaStream_t stream) {
  constexpr int RPT = NC <= 8 ? 2 : 1;
  constexpr int BQ = GROUPS * RPT;
  const int smem = 2 * BK * 16 * NC * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, NC, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((sq + BQ - 1) / BQ), (unsigned int)(b * h));
  flash_fwd<T, NC, RPT><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, h, hkv, sq, skv, d, st,
      causal, window, softcap, sm_scale);
  return (int)cudaGetLastError();
}

// The smallest compiled chunk count that covers ceil(d / 16) chunks.
template <typename T>
static int launch_t(int nc, const void* q, const void* k, const void* v,
                    void* o, int b, int h, int hkv, int sq, int skv, int d,
                    const Strides& st, int causal, int window, float softcap,
                    float sm_scale, cudaStream_t s) {
#define FLASH_CASE(N)                                                        \
  if (nc <= N)                                                               \
    return launch_nc<T, N>(q, k, v, o, b, h, hkv, sq, skv, d, st, causal,    \
                           window, softcap, sm_scale, s);
  FLASH_CASE(1)
  FLASH_CASE(2)
  FLASH_CASE(4)
  FLASH_CASE(5)
  FLASH_CASE(7)
  FLASH_CASE(8)
  FLASH_CASE(9)
  FLASH_CASE(12)
  FLASH_CASE(15)
  FLASH_CASE(20)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The largest head dim the kernel takes.
int flash_attention_max_head_dim(void) { return 16 * MAX_NC; }

// window ≤ 0: no window; softcap ≤ 0: no softcap; bf16: 1 for bfloat16
// tensors, 0 for float32.  Strides in elements.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int b, int h, int hkv, int sq, int skv,
                           int d, long long qsb, long long qsh, long long qss,
                           long long ksb, long long ksh, long long kss,
                           long long vsb, long long vsh, long long vss,
                           long long osb, long long osh, long long oss,
                           int causal, int window, float softcap,
                           float sm_scale, int bf16, void* stream) {
  if (b == 0 || h == 0 || sq == 0) return (int)cudaSuccess;
  if (b < 0 || h < 1 || hkv < 1 || h % hkv != 0 || sq < 0 || skv < 0 ||
      d < 1 || d > 16 * MAX_NC || (long long)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  const int nc = (d + 15) / 16;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_t<__nv_bfloat16>(nc, q, k, v, o, b, h, hkv, sq, skv, d, st,
                                   causal, window, softcap, sm_scale, s);
  return launch_t<float>(nc, q, k, v, o, b, h, hkv, sq, skv, d, st, causal,
                         window, softcap, sm_scale, s);
}

}  // extern "C"
