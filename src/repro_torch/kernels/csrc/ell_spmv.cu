// ELL gather-reduce y = Φ u for sm_90a:  y[m, r] = Σ_k vals[m,k]·u[cols[m,k], r].
//
// Replaces the TPU kernel src/repro/kernels/ell_spmv/ell_spmv.py:42
// `ell_spmv` (pallas_call at :77, body `_spmv_kernel` :28).  Plain version:
// repro_torch/kernels/ell_spmv/ref.py `ell_spmv_ref`.
//
// What bounds it on this card: bytes.  Each slot costs 8 payload bytes
// (vals + cols) against 2·R flops, so the least time is the payload read
// once, the rows of u that the non-zero slots touch read once and y written
// once: (M·K·8 + U·R·4 + M·R·4) / HBM rate, U the distinct columns reached
// (0.153 ms at [10⁶, 48], R = 16).  The TPU kernel streamed the payload once
// and kept all of u resident in VMEM; here u stays in global memory, and
// the gathers of a row block, which graph-local walks keep within a few
// neighbouring rows of u, are served by L1 and L2.  What keeps a kernel
// from that bound is latency: a row's payload comes from HBM and its
// gathers then from L2, so the card needs many rows in flight at once.
//
// Design.
//   P lanes own a row and a warp 32/P consecutive rows.  L of them cover a
//   row of u in the instance's units (R/4 float4s in the vector instance,
//   R floats in the scalar one; L the least power of two covering it, at
//   most 32, wider rows walked by blockIdx.y in chunks of L units), and the
//   row's slots are split into S = max(1, 4/L) parts, so P = L·S ≥ 4.  At
//   R = 16 four lanes take a slot's u row as float4s and a warp holds 8
//   rows, so 8 slots are in flight per gather instruction; at R = 1 four
//   lanes split a row's slots and meet in a fixed xor butterfly.  `route`
//   in kernels/ell_spmv/ops.py picks the instance, L and S.  Many rows a
//   warp is the point: a row's payload and then its gathers are two
//   dependent round trips, and one row a warp (the slots compacted by
//   ballots, 8 in flight a row) left the card waiting on them, slower on an
//   H100 than the thread-per-output kernel this replaced.
//   The warp copies its rows' payload once, coalesced and asynchronously
//   (cp.async: 16-byte copies when K % 4 == 0 and both bases are 16-byte
//   aligned, 4-byte ones otherwise), into shared memory, in stages of at
//   most 512 slots a warp (K = 48 is one stage at R = 16, K = 144 three),
//   the next stage in flight while this one is gathered; a row's lanes read
//   it back as 16-byte broadcasts (row stride an odd number of 16-byte
//   words, so the warp's rows fall in distinct banks).
//   Halted slots are skipped: a lane issues no gather for a slot whose
//   value is exactly ±0.  A halted walker keeps walking with load 0
//   (walk_sampler/ref.py), so its columns are real nodes, and every one of
//   them would otherwise cost a gather.
//   Each lane sums its slots in slot order, in float32 with FMA, a quad's
//   four gathers in flight at a time (eight cost more in registers, and so
//   in rows in flight, than they gain); the parts meet in the butterfly
//   and one lane writes y (16-byte stores in the vector instance).  No
//   atomics: the order depends on the shape only, and two calls give
//   bit-equal y.
// Against the plain version: the sum starts at +0, and adding ±0 never
// changes a float sum, so skipping a zero slot changes nothing, with one
// exception: a non-finite u on a column that only zero slots reach gives
// NaN in the plain version (0·inf) and is not read here.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#define WARPS 4            // warps a block
#define WARP_SLOTS 512     // payload slots a warp stages at once, over its rows

// Start copying one stage of the warp's `rows` rows (vals/cols at its first
// row), slots [j0, j0 + kk) of each, into sv/sc (row r at r·stride4 16-byte
// words), zero-padded to ⌈kk/4⌉ quads, as asynchronous copies (cp.async: no
// registers held while they fly) and commit them as one batch.  VEC: 16-byte
// copies, which need kk % 4 == 0 and 16-byte aligned rows.
template <bool VEC>
__device__ __forceinline__ void stage_rows(const float* __restrict__ vals,
                                           const int* __restrict__ cols,
                                           int rows, int k, int j0, int kk,
                                           int stride4, int lane, float4* sv,
                                           int4* sc) {
  const int q4 = (kk + 3) / 4;
  if (VEC) {
    const int n = rows * q4;
#pragma unroll 1   // copies hold no registers: nothing to gain from unrolling
    for (int i = lane; i < n; i += 32) {
      const int r = i / q4, f = i - r * q4;
      const int off = r * k + j0 + 4 * f;
      __pipeline_memcpy_async(sv + r * stride4 + f, vals + off, 16);
      __pipeline_memcpy_async(sc + r * stride4 + f, cols + off, 16);
    }
  } else {
    const int w = 4 * q4;   // a row's slots, padded
    const int n = rows * w;
    float* svf = reinterpret_cast<float*>(sv);
    int* scf = reinterpret_cast<int*>(sc);
#pragma unroll 1
    for (int i = lane; i < n; i += 32) {
      const int r = i / w, j = i - r * w;
      float* dv = svf + 4 * r * stride4 + j;
      int* dc = scf + 4 * r * stride4 + j;
      if (j < kk) {
        __pipeline_memcpy_async(dv, vals + r * k + j0 + j, 4);
        __pipeline_memcpy_async(dc, cols + r * k + j0 + j, 4);
      } else {
        *dv = 0.f;
        *dc = 0;
      }
    }
  }
  __pipeline_commit();
}

__device__ __forceinline__ void fma_into(float& acc, float a, float x) {
  acc = fmaf(a, x, acc);
}
__device__ __forceinline__ void fma_into(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ void add_lane(float& acc, int off) {
  acc += __shfl_xor_sync(0xffffffffu, acc, off);
}
__device__ __forceinline__ void add_lane(float4& acc, int off) {
  acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
  acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
  acc.z += __shfl_xor_sync(0xffffffffu, acc.z, off);
  acc.w += __shfl_xor_sync(0xffffffffu, acc.w, off);
}

// acc += Σ_j a_j·u[c_j][unit] over the quads first, first + step, ... < n
// of a staged row, in slot order, non-zero slots only; a quad's four
// gathers are issued before their sums.
template <typename T>
__device__ __forceinline__ void gather_row(const T* __restrict__ ub, int units,
                                           const float4* sv, const int4* sc,
                                           int n, int first, int step, T& acc) {
#pragma unroll 1   // one quad in flight a lane: more costs occupancy
  for (int f = first; f < n; f += step) {
    const float4 v = sv[f];
    const int4 j = sc[f];
    const float a[4] = {v.x, v.y, v.z, v.w};
    const int c[4] = {j.x, j.y, j.z, j.w};
    T x[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (a[t] != 0.f) x[t] = __ldg(ub + (long long)c[t] * units);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (a[t] != 0.f) fma_into(acc, a[t], x[t]);
  }
}

// P = L·S lanes a row and 32/P rows a warp: L = 2^lshift lanes cover L
// units of a row of u (blockIdx.y the chunk of L units), S = 2^sshift
// parts of the row's quads (part p takes quads p, p + S, ...), which meet
// in a fixed xor butterfly.  T float (scalar) or float4 (vector); VEC:
// 16-byte payload copies.  Dynamic
// shared memory: per warp, `bufs` stage buffers (two when a row takes
// several stages: the next stage flies while this one is gathered), each
// 32/P rows of stride4 16-byte words of values, then as many of columns.
// ONE: a row is one stage (1 ≤ K ≤ stage) and one chunk of u, so the stage
// loop, the second buffer and the chunk offset compile away.
template <typename T, bool VEC, bool ONE>
__global__ void __launch_bounds__(WARPS * 32)
    ell_spmv_rows(const float* __restrict__ vals, const int* __restrict__ cols,
                  const T* __restrict__ u, T* __restrict__ y, long long m_rows,
                  int k, int units, int lshift, int sshift, int stage,
                  int stride4, int bufs) {
  const int pshift = lshift + sshift, rw = 32 >> pshift;
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long m0 = ((long long)blockIdx.x * WARPS + wid) * rw;
  if (m0 >= m_rows) return;   // warp-uniform: only warp-level syncs follow
  const int rows = m_rows - m0 < rw ? (int)(m_rows - m0) : rw;
  const int g = lane >> pshift, part = (lane >> lshift) & ((1 << sshift) - 1);
  const int unit =
      (ONE ? 0 : blockIdx.y << lshift) + (lane & ((1 << lshift) - 1));
  const bool act = g < rows && unit < units;
  const int cw = rw * stride4, words = 2 * cw;   // column words, one buffer
  if (ONE) bufs = 1;
  float4* const buf = smem + wid * bufs * words;
  vals += m0 * k;   // the warp's rows
  cols += m0 * k;
  const T* const ub = u + unit;
  const int stages = ONE ? 1 : (k + stage - 1) / stage;
  T acc = T();   // +0 in every component
  for (int s = 0; s < stages; ++s) {
    float4* const cur = buf + (s & (bufs - 1)) * words;   // bufs is 1 or 2
    const int j0 = s * stage, kk = min(stage, k - j0);
    if (s == 0 || bufs == 1) {   // this stage was not started ahead
      __syncwarp();   // the buffer has been read
      stage_rows<VEC>(vals, cols, rows, k, j0, kk, stride4, lane, cur,
                      reinterpret_cast<int4*>(cur + cw));
    }
    if (bufs == 2 && s + 1 < stages) {   // start the next one
      float4* const nxt = buf + ((s + 1) & 1) * words;
      stage_rows<VEC>(vals, cols, rows, k, j0 + stage, min(stage, k - j0 - stage),
                      stride4, lane, nxt, reinterpret_cast<int4*>(nxt + cw));
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();   // every lane's copies have landed
    if (act)
      gather_row(ub, units, cur + g * stride4,
                 reinterpret_cast<const int4*>(cur + cw) + g * stride4,
                 (kk + 3) / 4, part, 1 << sshift, acc);
    __syncwarp();   // read before the buffer is refilled
  }
  for (int off = 1 << lshift; off < 1 << pshift; off <<= 1) add_lane(acc, off);
  if (act && part == 0) y[(m0 + g) * units + unit] = acc;
}

template <typename T, bool VEC>
static int launch_rows(const void* vals, const void* cols, const void* u,
                       void* y, long long m_rows, int k, int units,
                       int lshift, int sshift, cudaStream_t stream) {
  const int rw = 32 >> (lshift + sshift);
  // Stages of equal length, a multiple of 4 slots, at most WARP_SLOTS/rw.
  const int per_row = WARP_SLOTS / rw;
  const int stages = k <= per_row ? 1 : (k + per_row - 1) / per_row;
  int stage = ((k + stages - 1) / stages + 3) & ~3;
  if (stage == 0) stage = 4;
  const int stride4 = (stage / 4) | 1;   // odd: the rows' words in distinct banks
  const int bufs = stages > 1 ? 2 : 1;
  const long long warps = (m_rows + rw - 1) / rw;
  const long long blocks = (warps + WARPS - 1) / WARPS;
  const int chunks = (units + (1 << lshift) - 1) >> lshift;
  if (blocks > 0x7fffffffLL || chunks > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)WARPS * bufs * 2 * rw * stride4 * sizeof(float4);
  const dim3 grid((unsigned int)blocks, chunks);
  if (k > 0 && stages == 1 && chunks == 1)
    ell_spmv_rows<T, VEC, true><<<grid, WARPS * 32, smem, stream>>>(
        (const float*)vals, (const int*)cols, (const T*)u, (T*)y, m_rows, k,
        units, lshift, sshift, stage, stride4, bufs);
  else
    ell_spmv_rows<T, VEC, false><<<grid, WARPS * 32, smem, stream>>>(
        (const float*)vals, (const int*)cols, (const T*)u, (T*)y, m_rows, k,
        units, lshift, sshift, stage, stride4, bufs);
  return (int)cudaGetLastError();
}

static int log2_of(int x) {   // -1 unless x is a power of two
  for (int s = 0; s < 31; ++s)
    if (x == 1 << s) return s;
  return -1;
}

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// vector: 1 for the float4 instance (r % 4 == 0, u and y 16-byte aligned);
// lanes, parts: lanes covering a row of u and parts of the row's slots,
// powers of two with lanes·parts ≤ 32; vec_payload: 1 when K % 4 == 0 and
// vals and cols are 16-byte aligned.
int ell_spmv_launch(const void* vals, const void* cols, const void* u, void* y,
                    long long m_rows, int k, int r, int vector, int lanes,
                    int parts, int vec_payload, void* stream) {
  if (m_rows == 0 || r == 0) return (int)cudaSuccess;
  const int ls = log2_of(lanes), ss = log2_of(parts);
  if (ls < 0 || ss < 0 || ls + ss > 5 || (vec_payload && k % 4 != 0) ||
      (vector && r % 4 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (vector)
    return vec_payload
               ? launch_rows<float4, true>(vals, cols, u, y, m_rows, k, r / 4, ls, ss, st)
               : launch_rows<float4, false>(vals, cols, u, y, m_rows, k, r / 4, ls, ss, st);
  return vec_payload
             ? launch_rows<float, true>(vals, cols, u, y, m_rows, k, r, ls, ss, st)
             : launch_rows<float, false>(vals, cols, u, y, m_rows, k, r, ls, ss, st);
}

}  // extern "C"
