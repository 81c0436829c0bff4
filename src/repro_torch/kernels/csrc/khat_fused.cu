// Fused K̂ matvec y = Φ_rows (Φ_colsᵀ v) for sm_90a, through a column index.
//
// Replaces the TPU kernel src/repro/kernels/ell_spmv/khat_fused.py:83
// `khat_matvec_fused` (pallas_call at :126, body `_khat_kernel` :34).  Plain
// versions: repro_torch/kernels/ell_spmv/ref.py `khat_matvec_ref` (the
// function) and `khat_matvec_indexed_ref` (this kernel's algorithm).
//
// What bounds it on this card: bytes.  The square training-block product of
// every CG iteration (K̂_xx p) reads the payload once, T·K·(2 or 4 + 4)
// bytes, and v and y, T·R·4 each; the cross form K̂_{·x}α over all N rows
// reads the N·K row payload and writes N·R floats.  Nothing N-long is
// needed between the two halves: u = Φ_colsᵀ v is non-zero only on the U
// columns that a non-zero slot of Φ_cols touches (10 822 of 10⁶ at the
// posterior's T = 1024, K = 48; 4022 at the solvers' T = 4000, K = 144).
//
// Design.  The TPU kernel kept an N-long u in VMEM and scattered into it.
// On this card an N-long u would cost an [N, R] zeroing every call (64 MB
// at the posterior's R = 16) and float atomics, ≈97 on each address at the
// solvers' shape.  Instead the wrapper passes a column index of Φ_cols
// (index.py: the U distinct columns, the non-zero slots sorted by column
// with segment offsets, and an int32 node → compact-id map), built once per
// walk trace, and the product is two plain launches on the stream:
//   segments  one warp per distinct column sums its segment,
//             u[c, r] = Σ_s vals_c[s]·v[row(s), r], into a compact [U, R];
//   gather    one warp per row of Φ_rows, y[m, r] = Σ_k vals_r·u[map[col]],
//             where a slot whose column is not in the index reads no value
//             and adds nothing (almost every slot of the cross form).
// Two launches rather than one cooperative one: each grid is sized to its
// own work, and nothing waits on a grid-wide barrier.  In both, a warp takes
// its slots 32 at a time, compacts the non-zero ones (ballot, prefix count)
// into shared memory, and its lanes split as 32/RP groups of RP lanes (RP
// the power of two ≥ min(R, 32)): a group takes every (32/RP)-th compacted
// slot, a lane one of R's columns, so that R = 1 uses all 32 lanes and R =
// 16 reads 64 contiguous bytes of v or u per slot.  The groups' partial sums
// meet in a fixed butterfly of shuffles.  No atomics: each output is
// written once, in an order fixed by the index, so two calls give bit-equal
// results.  bf16 payloads are upcast with __bfloat162float; u and every sum
// are float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define WARPS 8
#define FULL 0xffffffffu

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Compact this warp's non-zero (index, value) pairs into s_idx/s_val, in
// lane order; returns how many there are.
__device__ __forceinline__ int compact(bool keep, int idx, float val,
                                       int lane, int* s_idx, float* s_val) {
  const unsigned m = __ballot_sync(FULL, keep);
  if (keep) {
    const int at = __popc(m & ((1u << lane) - 1u));
    s_idx[at] = idx;
    s_val[at] = val;
  }
  __syncwarp();
  return __popc(m);
}

// acc += Σ_h s_val[h]·dense[s_idx[h], r0 + rr] over group g's share.
__device__ __forceinline__ float accumulate(float acc, int cnt, const int* s_idx,
                                            const float* s_val,
                                            const float* __restrict__ dense,
                                            int r, int col, int g, int groups) {
  if (col < r)
    for (int h = g; h < cnt; h += groups)
      acc += s_val[h] * dense[(long long)s_idx[h] * r + col];
  __syncwarp();
  return acc;
}

__device__ __forceinline__ float sum_groups(float acc, int rp) {
  for (int off = rp; off < 32; off <<= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    khat_segments(const T* __restrict__ vals_c, const int* __restrict__ order,
                  const int* __restrict__ seg, const float* __restrict__ v,
                  float* __restrict__ u, int n_uniq, int k_c, int r, int rp) {
  __shared__ int s_idx[WARPS][32];
  __shared__ float s_val[WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int groups = 32 / rp, g = lane / rp, rr = lane - g * rp;
  for (long long c = (long long)blockIdx.x * WARPS + w; c < n_uniq;
       c += (long long)gridDim.x * WARPS) {
    const int s0 = seg[c], s1 = seg[c + 1];
    for (int r0 = 0; r0 < r; r0 += rp) {
      float acc = 0.0f;
      for (int c0 = s0; c0 < s1; c0 += 32) {
        int row = 0;
        float val = 0.0f;
        if (c0 + lane < s1) {
          const int p = order[c0 + lane];
          val = to_f32(vals_c[p]);
          row = p / k_c;
        }
        const int cnt = compact(val != 0.0f, row, val, lane, s_idx[w], s_val[w]);
        acc = accumulate(acc, cnt, s_idx[w], s_val[w], v, r, r0 + rr, g, groups);
      }
      acc = sum_groups(acc, rp);
      if (g == 0 && r0 + rr < r) u[c * r + r0 + rr] = acc;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    khat_gather(const T* __restrict__ vals_r, const int* __restrict__ cols_r,
                const int* __restrict__ node_map, const float* __restrict__ u,
                float* __restrict__ y, long long m_r, int k_r, int r, int rp) {
  __shared__ int s_idx[WARPS][32];
  __shared__ float s_val[WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int groups = 32 / rp, g = lane / rp, rr = lane - g * rp;
  for (long long m = (long long)blockIdx.x * WARPS + w; m < m_r;
       m += (long long)gridDim.x * WARPS) {
    const T* vrow = vals_r + m * k_r;
    const int* crow = cols_r + m * k_r;
    for (int r0 = 0; r0 < r; r0 += rp) {
      float acc = 0.0f;
      for (int c0 = 0; c0 < k_r; c0 += 32) {
        int id = -1;
        float val = 0.0f;
        if (c0 + lane < k_r) {
          id = node_map[crow[c0 + lane]];
          if (id >= 0) val = to_f32(vrow[c0 + lane]);
        }
        const int cnt = compact(val != 0.0f, id, val, lane, s_idx[w], s_val[w]);
        acc = accumulate(acc, cnt, s_idx[w], s_val[w], u, r, r0 + rr, g, groups);
      }
      acc = sum_groups(acc, rp);
      if (g == 0 && r0 + rr < r) y[m * r + r0 + rr] = acc;
    }
  }
}

static int sm_count() {
  static int cached[32] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 32 && cached[dev]) return cached[dev];
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < 32) cached[dev] = sms;
  return sms;
}

static unsigned int grid_for(long long warps, int sms) {
  long long blocks = (warps + WARPS - 1) / WARPS;
  const long long most = 16LL * sms;   // then grid-stride
  if (blocks > most) blocks = most;
  return (unsigned int)(blocks < 1 ? 1 : blocks);
}

template <typename T>
static int launch(const void* vals_r, const void* cols_r, const void* vals_c,
                  const void* order, const void* seg, const void* node_map,
                  const void* v, void* u, void* y, long long m_r, int k_r,
                  int k_c, int n_uniq, int r, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInitializationError;
  int rp = 1;
  while (rp < r && rp < 32) rp <<= 1;
  if (n_uniq > 0) {
    khat_segments<T><<<grid_for(n_uniq, sms), WARPS * 32, 0, stream>>>(
        (const T*)vals_c, (const int*)order, (const int*)seg, (const float*)v,
        (float*)u, n_uniq, k_c, r, rp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (m_r > 0) {
    khat_gather<T><<<grid_for(m_r, sms), WARPS * 32, 0, stream>>>(
        (const T*)vals_r, (const int*)cols_r, (const int*)node_map,
        (const float*)u, (float*)y, m_r, k_r, r, rp);
  }
  return (int)cudaGetLastError();
}

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32 payloads, 1 = bfloat16 payloads (both sides).  order,
// seg and node_map are the column index of the column payload; u is an
// [n_uniq, r] float32 scratch; v is [m_c, r], y [m_r, r].
int khat_fused_launch(const void* vals_r, const void* cols_r,
                      const void* vals_c, const void* order, const void* seg,
                      const void* node_map, const void* v, void* u, void* y,
                      long long m_r, int k_r, int k_c, int n_uniq, int r,
                      int dtype, void* stream) {
  if (r < 1 || k_r < 0 || k_c < 0 || n_uniq < 0 || m_r < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(vals_r, cols_r, vals_c, order, seg, node_map,
                                 v, u, y, m_r, k_r, k_c, n_uniq, r, s);
  return launch<float>(vals_r, cols_r, vals_c, order, seg, node_map, v, u, y,
                       m_r, k_r, k_c, n_uniq, r, s);
}

}  // extern "C"
