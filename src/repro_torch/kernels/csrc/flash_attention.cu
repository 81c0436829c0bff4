// FlashAttention forward for sm_90a: online softmax over KV tiles, GQA
// (kv head = q head // (H / Hkv)), causal and sliding-window masks, a
// kv-length mask, an optional tanh logit softcap applied before the masks,
// masked logits set to -1e30 with p zeroed on masked keys, float32 softmax
// statistics, and rows that see no key written as 0.
//   q [B, H, Sq, D], k/v [B, Hkv, Skv, D], o [B, H, Sq, D]; float32 or
//   bfloat16 in (all three alike), o in the input type.
// Each tensor is addressed through its own batch, head and sequence strides;
// the head dim must be contiguous.  Query row r sits at global position
// r + q_offset (a shard of a sequence-parallel q): the masks and the tile
// ranges use that position, and at q_offset = 0 every instruction is the one
// it was before the argument existed.
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
// (q, k, v read once, o written once) are 59 MB, 17.6 µs at 3.35 TB/s.
//
// Two instances, chosen by the wrapper (flash_attention/ops.py `route`) from
// the dtype, the head dim and the alignment, never by a knob:
//
// 1. Tensor cores (`flash_fwd_tc`, entry flash_attention_tc_launch): bf16
//    with D a multiple of 8 up to 256, 16-byte aligned bases and strides.
//    The Hopper design: `wgmma` from consumer warpgroups, K/V tiles by TMA
//    into an mbarrier ring fed by a producer warp.  A block owns 128 query
//    rows of one (batch, head): two consumer warpgroups of 64 rows (one at
//    D = 256, where the accumulator needs the registers that 288 threads
//    leave: ptxas caps those at 168) and one producer warp.
//    - Producer: one thread streams each KV tile of 64 keys into a ring of
//      2–4 shared-memory stages (as many as fit beside Q) with two TMA box
//      copies, after `mbarrier.arrive.expect_tx` on the stage's "full"
//      barrier, once the stage's "empty" barrier says every consumer warp
//      has read its last contents.  Tensor maps are encoded on the host per
//      call with cuTensorMapEncodeTiled, reached through
//      cudaGetDriverEntryPoint (no -lcuda), and passed as __grid_constant__
//      parameters.
//    - Consumers: S = Q·Kᵀ as `wgmma.m64n64k16` with Q and K from shared
//      memory; the online softmax on the accumulator fragments in registers
//      (each thread holds two rows; the row max and sum are reduced across
//      the quad of lanes that share a row), in the log2 domain with the
//      scale and log2(e) folded into one FMA before `ex2.approx`; the
//      softcap (tanhf) and the masks are loops of their own behind uniform
//      branches, so the interior tiles of a causal layer without softcap
//      run neither.  P is rounded to bf16, as the TPU's MXU does at default
//      precision, and packed straight from the S accumulator into the A
//      registers of O += P·V (`wgmma.m64nDk16`, V from shared memory,
//      MN-major); the row sum l is taken from the same rounded values.  Q,
//      K and V are bf16 already, so S is exact up to summation order.
//    - Layout, and D = 80 (danube): 160 bytes a row is not a multiple of the
//      128-byte swizzle span, so no swizzle is used.  Tiles are kept in the
//      no-swizzle core-matrix layout (8 rows × 16 bytes, 128 contiguous
//      bytes per core matrix) ordered chunk-major: 16-byte chunk c of row r
//      at (c·rows + r)·16.  A 5-D TMA box over (8 elements, rows, chunks,
//      kv heads, batch) writes exactly that, so D = 80 is five chunks with
//      no padding of the products and no second box; a descriptor's LBO is
//      the core-matrix stride along K and its SBO along M or N, for both
//      majors.  Q (loaded once per block) takes the same layout by
//      cp.async.  Head dims: compiled for padded widths DP in {16, 32, 64,
//      80, 128, 144, 256}; a head dim takes the smallest DP ≥ D, the boxes
//      carry D/8 chunks, and the chunks past D are zeroed once per block.
//    - It walks only the KV tiles that the causal and window masks leave
//      open for some of its rows (the TPU kernel's `pl.when` skip,
//      :80-91), and a warpgroup skips the products of a tile masked for all
//      of its rows.  GQA: the block index runs fastest over the q heads of a
//      group at one q tile, so the group's blocks run together and read the
//      same K/V tiles (from L2 after the first); q tiles go in reverse
//      order, longest first.  Ragged Sq and Skv are masked in registers
//      (TMA zero-fills rows past Skv), never padded in memory.
//    - Not yet: ping-pong scheduling of the two consumer warpgroups and the
//      overlap of one tile's softmax with the next tile's products inside a
//      warpgroup (FlashAttention-3's), which ROADMAP keeps open.
//
// 2. CUDA cores (`flash_fwd`, entry flash_attention_launch): float32 inputs
//    (whose 2e-5 parity cannot be met with TF32 or bf16 products), any D
//    from 1 to 320, and bf16 inputs that the tensor-core instance does not
//    take (D not a multiple of 8, D > 256, or a misaligned view).  One block
//    of 256 threads owns one (batch·head, q tile) pair and loops over the KV
//    tiles itself: four threads share a query row, each holding a quarter of
//    its head dims (16-byte chunks, interleaved so that the four read
//    neighbouring words) of q and of the output accumulator in registers,
//    with the row's running max m and sum l.  A KV tile of 32 keys is staged
//    in shared memory as float32 (zero-padded past Skv and past D); each
//    key's logit is the four partial dot products summed by two shuffles.
//    The online softmax runs over 16 keys at a time: logits (softcapped,
//    then masked to -1e30), the new max, one rescale of acc and l, then
//    p = exp(s − m) zeroed on masked keys and acc += p·v.  It visits the
//    same open KV tiles.  Threads hold two query rows each where D ≤ 128 (q
//    tile 128 rows), one above (q tile 64 rows).  float32 arithmetic.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
              const T* __restrict__ v, T* __restrict__ o, int nbh, int h,
              int hkv, int sq, int skv, int d, Strides st, int causal,
              int qoff, int window, float softcap, float sm_scale) {
  constexpr int DP = 16 * NC;
  constexpr int BQ = GROUPS * RPT;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + BK * DP;

  // (batch, head) folded over grid.y and grid.z: B·H may pass 65535.
  const int bh = blockIdx.y + blockIdx.z * gridDim.y;
  if (bh >= nbh) return;
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

  // The KV range some row of this q tile may see; query row r sits at
  // global position r + qoff.
  const int i_lo = q0 + qoff;
  const int i_hi = min(q0 + BQ, sq) - 1 + qoff;
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
          const int i = row[t] + qoff;
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

// cudaFuncAttributeMaxDynamicSharedMemorySize of `kern`, set once per
// device and instance: a host call that would otherwise cost every launch,
// and one that a CUDA graph capture need not see.
template <auto Kern>
static cudaError_t set_smem_once(int smem) {
  static unsigned int ready = 0u;   // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && ((ready >> dev) & 1u))) return err;
  err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && dev < 32) ready |= 1u << dev;
  return err;
}

template <typename T, int NC>
static int launch_nc(const void* q, const void* k, const void* v, void* o,
                     int b, int h, int hkv, int sq, int skv, int d,
                     const Strides& st, int causal, int qoff, int window,
                     float softcap, float sm_scale, cudaStream_t stream) {
  constexpr int RPT = NC <= 8 ? 2 : 1;
  constexpr int BQ = GROUPS * RPT;
  const int smem = 2 * BK * 16 * NC * (int)sizeof(float);
  cudaError_t err = set_smem_once<flash_fwd<T, NC, RPT>>(smem);
  if (err != cudaSuccess) return (int)err;
  const int nbh = b * h;
  const int gy = nbh < 65535 ? nbh : 65535;
  const dim3 grid((unsigned int)((sq + BQ - 1) / BQ), (unsigned int)gy,
                  (unsigned int)((nbh + gy - 1) / gy));
  flash_fwd<T, NC, RPT><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, nbh, h, hkv, sq, skv, d,
      st, causal, qoff, window, softcap, sm_scale);
  return (int)cudaGetLastError();
}

// The smallest compiled chunk count that covers ceil(d / 16) chunks.
template <typename T>
static int launch_t(int nc, const void* q, const void* k, const void* v,
                    void* o, int b, int h, int hkv, int sq, int skv, int d,
                    const Strides& st, int causal, int qoff, int window,
                    float softcap, float sm_scale, cudaStream_t s) {
#define FLASH_CASE(N)                                                        \
  if (nc <= N)                                                               \
    return launch_nc<T, N>(q, k, v, o, b, h, hkv, sq, skv, d, st, causal,    \
                           qoff, window, softcap, sm_scale, s);
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


// ---------------------------------------------------------------------------
// Tensor-core instance (bf16): wgmma, TMA, an mbarrier ring, a producer warp.
// ---------------------------------------------------------------------------

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int TK = 64;                  // keys per KV tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronously; bytes == 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// 2^x on the special-function unit (what exp2f becomes under fast math).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 and packed (the first in the low half); `sum`
// gains the two values as rounded.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float& sum) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  sum += __low2float(v) + __high2float(v);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// mbarriers.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts any real one by orders of magnitude traps rather than hangs.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int i = 0; !mbar_try_wait(bar, parity); ++i)
    if (i > (1 << 26)) asm volatile("trap;\n");
}

// TMA: one 5-D box copy global → shared, completing on an mbarrier.
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            int c4, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor of a wgmma operand, no swizzle: start
// address, LBO = byte stride between core matrices along K, SBO = along M
// (or N).  Both majors read them so (checked on the card).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma m64nNk16, bf16 in, f32 accumulate, one asm per N; scale_d = 0
// overwrites the accumulator.  SS: A and B from shared memory, both K-major
// (S = Q·Kᵀ, N = 64 keys).  RS: A from registers, B from shared memory
// MN-major, tnspB = 1 (O += P·V, N = DP).
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int scale_d);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39 "
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<144>(float (&d)[72],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71 "
      "}, {%72, %73, %74, %75}, %76, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Copy rows [r0, r0 + BQ) of q (row stride rs), NTH threads, into the chunk-major
// core-matrix layout that the TMA boxes of K and V have too: 16-byte chunk c
// of row r at (c·BQ + r)·16, so core matrix (row group, chunk) is 128
// contiguous bytes.  Chunks past D and rows past rmax are zero-filled.
template <int DP, int BQ, int NTH>
__device__ __forceinline__ void load_q(uint32_t dst, const bf16* src,
                                       long long rs, int r0, int rmax,
                                       int dch) {
  constexpr int CH = DP / 8;
#pragma unroll 4
  for (int u = 0; u < (BQ * CH + NTH - 1) / NTH; ++u) {
    const int idx = threadIdx.x + u * NTH;
    if (BQ * CH % NTH != 0 && idx >= BQ * CH) break;
    const int c = idx / BQ;
    const int r = idx - c * BQ;
    const bool ok = r0 + r < rmax && c < dch;
    const bf16* g = ok ? src + (long long)(r0 + r) * rs + 8 * c : src;
    cp_async16(dst + 16 * idx, g, ok ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// DP: padded head dim; STAGES: depth of the K/V ring; NWG: consumer
// warpgroups of 64 query rows, beside one producer warp.  tmk, tmv: 5-D
// maps (8 elements, rows, 16-byte chunks, kv heads, batch) of k and v, whose
// boxes of TK rows land chunk-major.
template <int DP, int STAGES, int NWG>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
    flash_fwd_tc(const bf16* __restrict__ q,
                 const __grid_constant__ CUtensorMap tmk,
                 const __grid_constant__ CUtensorMap tmv, bf16* __restrict__ o,
                 int h, int hkv, int sq, int skv, int d, Strides st, int causal,
                 int qoff, int window, float softcap, float sm_scale) {
  constexpr int BQ = 64 * NWG;          // query rows per block
  constexpr int NTH = 128 * NWG + 32;   // consumers and the producer warp
  constexpr int NT = TK / 8;            // n8 blocks of S
  constexpr int NO = DP / 8;            // n8 blocks of O
  constexpr int KS = DP / 16;           // k16 steps of Q·Kᵀ
  constexpr uint32_t TILE_Q = BQ * DP * 2, TILE_KV = TK * DP * 2;
  extern __shared__ float4 smem4[];
  const uint32_t qs = smem_u32(smem4);
  const uint32_t ks = qs + TILE_Q;
  const uint32_t vs = ks + STAGES * TILE_KV;
  const uint32_t full = vs + STAGES * TILE_KV;   // STAGES mbarriers
  const uint32_t empty = full + 8 * STAGES;      // STAGES mbarriers

  // Block → (batch, kv head, q tile, q head of the group), the group's heads
  // fastest and the q tiles longest first.
  const int grp = h / hkv;
  const int ntq = (sq + BQ - 1) / BQ;
  int id = blockIdx.x;
  const int gq = id % grp;
  id /= grp;
  const int qt = ntq - 1 - id % ntq;
  id /= ntq;
  const int hk = id % hkv;
  const int b = id / hkv;
  const int hq = hk * grp + gq;
  const bf16* qb = q + b * st.qb + hq * st.qh;
  bf16* ob = o + b * st.ob + hq * st.oh;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int dch = d >> 3;
  const int q0 = qt * BQ;

  // The KV tiles some row of this block may see; query row r sits at
  // global position r + qoff.
  const int i_hi = min(q0 + BQ, sq) - 1 + qoff;
  int k_begin = 0, k_end = skv;
  if (causal) k_end = min(skv, i_hi + 1);
  if (window > 0) k_begin = max(0, q0 + qoff - window + 1);
  const int t0 = k_begin / TK;
  const int n_tiles = k_end > t0 * TK ? (k_end - t0 * TK + TK - 1) / TK : 0;

  // Q by every thread; the chunks of the K/V stages past D, which the TMA
  // boxes (D/8 chunks) never write, zeroed once; the barriers by one thread.
  // Then the roles part for good.
  load_q<DP, BQ, NTH>(qs, qb, st.qs, q0, sq, dch);
  if (dch < DP / 8) {
    float4* zero = reinterpret_cast<float4*>(smem4) + TILE_Q / 16;
    for (int i = threadIdx.x; i < 2 * STAGES * TK * DP / 8; i += NTH)
      if ((i / TK) % (DP / 8) >= dch) zero[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (warp == 4 * NWG) {
    // Producer: one thread puts tile it into stage it % STAGES, two TMA
    // boxes, once the consumers have released the stage.
    if (lane == 0) {
      const uint32_t bytes = 2 * TK * dch * 16;
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * stage, ((it / STAGES) - 1) & 1);
        mbar_expect_tx(full + 8 * stage, bytes);
        tma_load_5d(ks + stage * TILE_KV, &tmk, 0, (t0 + it) * TK, 0, hk, b,
                    full + 8 * stage);
        tma_load_5d(vs + stage * TILE_KV, &tmv, 0, (t0 + it) * TK, 0, hk, b,
                    full + 8 * stage);
      }
    }
    return;
  }

  // Consumers: warpgroup wgi owns rows g_lo .. g_lo + 63, warp & 3 a 16-row
  // slice of them, and each thread rows row0 and row0 + 8 of the slice (the
  // wgmma accumulator layout).
  const int wgi = warp >> 2;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int g_lo = q0 + 64 * wgi;
  const int g_hi = min(g_lo + 63, sq - 1);
  const int r_lo = g_lo + 16 * (warp & 3);
  const int r_hi = min(r_lo + 15, sq - 1);
  const int row0 = r_lo + g;
  // Logits into the log2 domain: x·sm_scale·log2(e) by the exponent's FMA
  // (e_mul), or softcap·tanh(x·sm_scale/softcap)·log2(e) before it.
  const bool capped = softcap > 0.0f;
  const float s_mul = sm_scale / softcap;
  const float cap_mul = softcap * LOG2E;
  const float e_mul = capped ? 1.0f : sm_scale * LOG2E;
  // Chunk-major tiles: core matrices 128 B apart along the rows (M or N for
  // Q and K, K for V) and rows·16 B apart along the head dim.
  const uint64_t dq = desc(qs + wgi * 64 * 16, BQ * 16, 128);

  float acc[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) acc[i] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % STAGES;
    mbar_wait(full + 8 * stage, (it / STAGES) & 1);
    const int k0 = (t0 + it) * TK;
    // A tile masked for every row of this warpgroup adds nothing: skip it.
    const bool active = g_lo < sq && !(causal && k0 > g_hi + qoff) &&
                        !(window > 0 && k0 + TK - 1 <= g_lo + qoff - window);
    if (active) {
      const uint64_t dk = desc(ks + stage * TILE_KV, TK * 16, 128);
      const uint64_t dv = desc(vs + stage * TILE_KV, 128, TK * 16);
      // S = Q·Kᵀ.
      float s[TK / 2];
#pragma unroll
      for (int i = 0; i < TK / 2; ++i) s[i] = 0.0f;
      hold(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_ss<TK>(s, dq + ((2 * kk * BQ * 16) >> 4),
                     dk + ((2 * kk * TK * 16) >> 4), kk > 0);
      wg_commit();
      wg_wait0();
      hold(s);
      // Online softmax, in the log2 domain: softcap, masks, the new max,
      // rescale, p = 2^(x − m) rounded to bf16 into the A fragments of P·V;
      // l sums the rounded p.  The softcap and the masks are loops of their
      // own behind uniform branches, so that a tile that needs neither runs
      // neither (tanhf is some twenty instructions).  A masked logit is
      // -1e30 before any scale: its p is 2^(-1e30·e_mul − m) = 0 for every
      // head dim (e_mul ≥ log2(e)/√320).
      const bool whole = k0 + TK <= skv &&
                         (!causal || k0 + TK - 1 <= r_lo + qoff) &&
                         (window <= 0 || k0 > r_hi + qoff - window);
      if (capped) {
#pragma unroll
        for (int i = 0; i < TK / 2; ++i) s[i] = cap_mul * tanhf(s[i] * s_mul);
      }
      if (!whole) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * n + 2 * t4 + (e & 1);
            const int i = row0 + (e < 2 ? 0 : 8) + qoff;
            const bool ok = kp < skv && (!causal || kp <= i) &&
                            (window <= 0 || kp > i - window);
            if (!ok) s[4 * n + e] = NEG_INF;
          }
      }
      // The tile's row max, still unscaled where there is no softcap, over
      // the quad of lanes that share a row.
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      mx0 = fmaxf(m0, mx0 == NEG_INF ? NEG_INF : mx0 * e_mul);
      mx1 = fmaxf(m1, mx1 == NEG_INF ? NEG_INF : mx1 * e_mul);
      const float alpha0 = ex2(m0 - mx0);
      const float alpha1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      // A row that has seen only masked keys has max -1e30: subtract 0
      // instead, so that its p = 2^-1e30 = 0, as a masked key's p is.
      const float mu0 = mx0 == NEG_INF ? 0.0f : mx0;
      const float mu1 = mx1 == NEG_INF ? 0.0f : mx1;
      uint32_t pa[NT][2];
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        pa[n][0] = pack_bf16(ex2(fmaf(s[4 * n], e_mul, -mu0)),
                             ex2(fmaf(s[4 * n + 1], e_mul, -mu0)), ps0);
        pa[n][1] = pack_bf16(ex2(fmaf(s[4 * n + 2], e_mul, -mu1)),
                             ex2(fmaf(s[4 * n + 3], e_mul, -mu1)), ps1);
      }
      l0 = l0 * alpha0 + ps0;
      l1 = l1 * alpha1 + ps1;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[4 * j] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }
      // O += P·V: P from registers (the S accumulator's n8 blocks 2kk and
      // 2kk + 1 are the A fragment of k-step kk), V MN-major.
      hold(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0],
                               pa[2 * kk + 1][1]};
        wgmma_rs<DP>(acc, a, dv + 16 * kk, 1);
      }
      wg_commit();
      wg_wait0();
      hold(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stage);   // the stage is read
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / (l0 == 0.0f ? 1.0f : l0);
  const float inv1 = 1.0f / (l1 == 0.0f ? 1.0f : l1);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (8 * j >= d) break;
    const int col = 8 * j + 2 * t4;
    if (row0 < sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)row0 * st.os + col) =
          pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (row0 + 8 < sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)(row0 + 8) * st.os + col) =
          pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver entry point, through the runtime: the
// library links no -lcuda.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 5-D map of a [B, Hkv, S, D] bf16 tensor (strides in elements) read in
// boxes of TK rows and D/8 chunks that land chunk-major: dims (8 elements,
// rows, chunks, kv heads, batch).  A dimension of length 1 gets stride 16
// (its coordinate is always 0); S = 0 becomes 1 (no tile is loaded then).
static int kv_map(CUtensorMap* map, const void* base, int b, int hkv, int s,
                  int d, long long sb, long long sh, long long ss) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[5] = {8, (cuuint64_t)(s > 0 ? s : 1),
                              (cuuint64_t)(d / 8), (cuuint64_t)hkv,
                              (cuuint64_t)b};
  const cuuint64_t strides[4] = {s > 1 ? (cuuint64_t)ss * 2 : 16, 16,
                                 hkv > 1 ? (cuuint64_t)sh * 2 : 16,
                                 b > 1 ? (cuuint64_t)sb * 2 : 16};
  const cuuint32_t box[5] = {8, TK, (cuuint32_t)(d / 8), 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

template <int DP, int STAGES, int NWG>
static int launch(const void* q, const void* k, const void* v, void* o, int b,
                  int h, int hkv, int sq, int skv, int d, const Strides& st,
                  int causal, int qoff, int window, float softcap,
                  float sm_scale, cudaStream_t stream) {
  CUtensorMap tmk, tmv;
  int rc = kv_map(&tmk, k, b, hkv, skv, d, st.kb, st.kh, st.ks);
  if (rc == 0) rc = kv_map(&tmv, v, b, hkv, skv, d, st.vb, st.vh, st.vs);
  if (rc != 0) return rc;
  constexpr int BQ = 64 * NWG;
  const int smem = (BQ + 2 * STAGES * TK) * DP * (int)sizeof(bf16) + 16 * STAGES;
  auto kern = flash_fwd_tc<DP, STAGES, NWG>;
  cudaError_t err = set_smem_once<flash_fwd_tc<DP, STAGES, NWG>>(smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)b * h * ((sq + BQ - 1) / BQ);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned int)blocks, 128 * NWG + 32, smem, stream>>>(
      (const bf16*)q, tmk, tmv, (bf16*)o, h, hkv, sq, skv, d, st, causal,
      qoff, window, softcap, sm_scale);
  return (int)cudaGetLastError();
}

// The smallest compiled padded head dim DP ≥ d (d a multiple of 8, ≤ 256),
// with the deepest K/V ring that fits beside Q in shared memory.
static int dispatch(const void* q, const void* k, const void* v, void* o,
                    int b, int h, int hkv, int sq, int skv, int d,
                    const Strides& st, int causal, int qoff, int window,
                    float softcap, float sm_scale, cudaStream_t s) {
#define TC_CASE(DP, STAGES, NWG)                                        \
  if (d <= DP)                                                          \
    return launch<DP, STAGES, NWG>(q, k, v, o, b, h, hkv, sq, skv, d, st, \
                                   causal, qoff, window, softcap, sm_scale, s);
  TC_CASE(16, 4, 2)
  TC_CASE(32, 4, 2)
  TC_CASE(64, 4, 2)
  TC_CASE(80, 4, 2)
  TC_CASE(128, 3, 2)
  TC_CASE(144, 3, 2)
  TC_CASE(256, 3, 1)
#undef TC_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The largest head dim the CUDA-core instance takes.
int flash_attention_max_head_dim(void) { return 16 * MAX_NC; }

// CUDA-core instance.  q_offset: the global position of q's row 0 (≥ 0),
// which the causal and window masks use; window ≤ 0: no window; softcap ≤ 0:
// no softcap; bf16: 1 for bfloat16 tensors, 0 for float32.  Strides in
// elements.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int b, int h, int hkv, int sq, int skv,
                           int d, long long qsb, long long qsh, long long qss,
                           long long ksb, long long ksh, long long kss,
                           long long vsb, long long vsh, long long vss,
                           long long osb, long long osh, long long oss,
                           int causal, int q_offset, int window, float softcap,
                           float sm_scale, int bf16, void* stream) {
  if (b == 0 || h == 0 || sq == 0) return (int)cudaSuccess;
  if (b < 0 || h < 1 || hkv < 1 || h % hkv != 0 || sq < 0 || skv < 0 ||
      q_offset < 0 ||
      d < 1 || d > 16 * MAX_NC || (long long)b * h > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  const int nc = (d + 15) / 16;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_t<__nv_bfloat16>(nc, q, k, v, o, b, h, hkv, sq, skv, d, st,
                                   causal, q_offset, window, softcap, sm_scale,
                                   s);
  return launch_t<float>(nc, q, k, v, o, b, h, hkv, sq, skv, d, st, causal,
                         q_offset, window, softcap, sm_scale, s);
}

// Tensor-core instance, bfloat16 only: d a multiple of 8 up to 256, every
// base 16-byte aligned and every stride of a dimension longer than 1 a
// multiple of 8 elements (the wrapper's rule, checked again here).
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* o, int b, int h, int hkv, int sq, int skv,
                              int d, long long qsb, long long qsh,
                              long long qss, long long ksb, long long ksh,
                              long long kss, long long vsb, long long vsh,
                              long long vss, long long osb, long long osh,
                              long long oss, int causal, int q_offset,
                              int window, float softcap, float sm_scale,
                              void* stream) {
  if (b == 0 || h == 0 || sq == 0) return (int)cudaSuccess;
  if (b < 0 || h < 1 || hkv < 1 || h % hkv != 0 || sq < 0 || skv < 0 ||
      q_offset < 0 || d < 8 || d > 256 || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  for (const void* p : ptrs)
    if ((unsigned long long)p % 16 != 0) return (int)cudaErrorInvalidValue;
  const long long strides[12] = {b > 1 ? qsb : 0,   h > 1 ? qsh : 0,
                                 sq > 1 ? qss : 0,  b > 1 ? ksb : 0,
                                 hkv > 1 ? ksh : 0, skv > 1 ? kss : 0,
                                 b > 1 ? vsb : 0,   hkv > 1 ? vsh : 0,
                                 skv > 1 ? vss : 0, b > 1 ? osb : 0,
                                 h > 1 ? osh : 0,   sq > 1 ? oss : 0};
  for (long long s : strides)
    if (s % 8 != 0) return (int)cudaErrorInvalidValue;
  const Strides st{qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  return tc::dispatch(q, k, v, o, b, h, hkv, sq, skv, d, st, causal, q_offset,
                      window, softcap, sm_scale, (cudaStream_t)stream);
}

}  // extern "C"
