// Fused Nyström–Woodbury preconditioner apply for sm_90a:
//   out = M⁻¹v = w − D⁻¹(B s),   w = D⁻¹v,   s = E⁻¹ Bᵀw,
// with B f32[T, r], D⁻¹ f32[T], E⁻¹ f32[r, r] and v, out f32[T, R].
//
// Replaces the TPU kernel src/repro/kernels/woodbury_apply/woodbury_apply.py:75
// `woodbury_apply` (pallas_call at :100, body `_woodbury_kernel` :41).  Plain
// version: repro_torch/kernels/woodbury_apply/ref.py `woodbury_apply_ref`.
//
// What bounds it on this card: bytes.  The function reads B, D⁻¹, E⁻¹ and v
// once and writes out once, (T·r + T + r² + 2·T·R)·4 bytes (0.65 µs at
// T = 4000, r = 128, R = 1 at 3.35 TB/s), against 4·T·r·R + 2·r²·R float32
// operations.  At the CG shapes it is bound by latency: B (2 MB at r = 128)
// stays in L2 across CG iterations, and a call is a chain of dependent
// steps (reduce over T, sum over blocks, E⁻¹ product, expand over T), each
// waiting on the one before; B's trip from L2 into the SMs that hold it is
// the longest of them.
//
// Design.  The TPU kernel ran a sequential (phase, block) grid with the
// rank-space sum in VMEM scratch.  Here a call is two ordinary launches, with
// no grid-wide barrier: `wb_partials` writes one [r, R] partial of Bᵀw per
// block of rows (≤ 64 of them), streaming B through a two-stage
// shared-memory ring (cp.async, 16-byte where rows allow); `wb_finish`, in
// clusters of 16 blocks (non-portable size), sums the partials in partial
// order and expands its rows, streaming B again from L2.  It forms all of u
// and s in every block where u and E⁻¹ are small (full mode), and otherwise
// splits the rows of s over the cluster's blocks and shares them through
// distributed shared memory between cluster barriers.  (One launch of a
// single 16-block cluster holding B in shared memory was measured too and
// taken out: it lost at every CG shape the paths run, PERF.md §6.)
// In shared memory B rows have stride r + 4 (16-byte rows; a column read by
// 8 rows × 4 lanes hits 32 banks) or an odd stride where r % 4 != 0.  A
// reduce thread owns a column j of B and a group of rows, an expand lane
// a row and a quarter of the columns, a solve lane a row of E⁻¹ and a
// quarter of k; each sum runs in a fixed order and the quarters meet in a
// fixed butterfly.  No float atomics: the order depends on the shape only,
// so two calls give bit-equal results.  Ragged T is handled by bounds
// checks, never by padding copies.  A launch takes up to 16 columns of v
// (the wrapper splits wider v, and narrower still past r = 512, so that an
// [r, columns] partial fits in 32 KB); columns are a template parameter, so
// each thread keeps its sums in registers.  r ≤ 8447.  Float32 FMA only; no
// tensor cores.  Results differ from the plain version's in summation order
// only: parity is to 1e-5 of scale.  The host side does nothing per call
// beyond the launch: ops.py::plan is cached per shape and sizes the
// scratch itself; each instance's attributes are set once per device.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NT 512                 // threads per block
#define CLUSTER 16             // blocks per cluster
#define MAX_CB 16              // columns of v per launch
#define SMEM_LIMIT 232448      // dynamic shared memory a block may have
#define MAX_RANK 8447
#define ES_MAX 8192            // floats of E⁻¹ rows a block keeps on chip
#define FULL_U 256             // r·columns up to which every block forms all of u…
#define FULL_E 16384           // …and, where E⁻¹ has at most this many floats, all of s

__host__ __device__ constexpr int cbp_of(int cb) { return cb <= 2 ? cb : (cb + 3) & ~3; }
__host__ __device__ inline long long round4(long long x) { return (x + 3) & ~3LL; }
// Row stride of B on chip: r + 4 keeps 16-byte rows for 16-byte copies and
// puts row i of a column 4i banks on (conflict-free in expand_rows' 8 × 4
// lane map); an odd stride where rows cannot be 16-byte copies.
__host__ __device__ inline int ld_of(int r) { return r % 4 == 0 ? r + 4 : (r | 1); }
// Small u and E⁻¹: every block forms all of u and all of s itself, which
// saves two cluster barriers and the exchange of s.
__host__ __device__ inline bool full_mode(int r, int cb) {
  return r * cb <= FULL_U && r * r <= FULL_E;
}

// Shared-memory layout, in floats, of a block holding `rows` rows of B
// (stride ld_of(r)), w (stride cbp) and D⁻¹, an [r, cbp] partial (later the
// gathered s), its own rows of u and of s, a combine buffer of one [cbp]
// row per thread (per row of u where a block sums more than 512, r > 8192),
// E⁻¹ (all of it in full mode; else its ⌈r/16⌉ rows where they fit in
// ES_MAX floats) and, in full mode, all of s.
// ops.py::_layout_floats mirrors it.
struct Layout {
  int ld, cbp, js;
  bool full;
  long long b, w, d, part, us, ss, gp, es, es_len, sf, total;
};

__host__ __device__ inline Layout layout(int rows, int r, int cb) {
  Layout L;
  L.ld = ld_of(r);
  L.cbp = cbp_of(cb);
  L.js = (r + CLUSTER - 1) / CLUSTER;
  L.full = full_mode(r, cb);
  const long long slice = (long long)L.js * r;
  L.es_len = L.full ? (long long)r * r : (slice <= ES_MAX ? slice : 0);
  long long o = 0;
  L.b = o;    o += round4((long long)rows * L.ld);
  L.w = o;    o += round4((long long)rows * L.cbp);
  L.d = o;    o += round4(rows);
  L.part = o; o += round4((long long)r * L.cbp);
  L.us = o;   o += round4((long long)L.js * L.cbp);
  L.ss = o;   o += round4((long long)L.js * L.cbp);
  L.gp = o;   o += round4((long long)(L.js > NT ? L.js : NT) * L.cbp);
  L.es = o;   o += round4(L.es_len);
  L.sf = o;   o += L.full ? round4((long long)r * L.cbp) : 0;
  L.total = o;
  return L;
}

__device__ __forceinline__ unsigned int smem_u32(const void* p) {
  return (unsigned int)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// x[0..CB) = p[0..CB), p aligned to its row stride cbp_of(CB).
template <int CB>
__device__ __forceinline__ void load_row(const float* p, float (&x)[CB]) {
  constexpr int P = cbp_of(CB);
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * q + k < CB) x[4 * q + k] = fv[k];
    }
  } else if constexpr (P == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  } else {
    x[0] = p[0];
  }
}

// Rows [row0, row0 + nr) of w = D⁻¹v and of D⁻¹ into ws and ds.
template <int CB>
__device__ void stage_w(float* ws, float* ds, const float* __restrict__ dinv,
                        const float* __restrict__ v, long long row0, int nr, int ldv,
                        int c0) {
  constexpr int P = cbp_of(CB);
  for (int e = threadIdx.x; e < nr * CB; e += NT) {
    const int i = e / CB, c = e - i * CB;
    const long long row = row0 + i;
    ws[i * P + c] = dinv[row] * v[row * ldv + c0 + c];
  }
  for (int i = threadIdx.x; i < nr; i += NT) ds[i] = dinv[row0 + i];
}

// Rows [row0, row0 + nr) of B into bs with cp.async (the caller commits):
// 16-byte copies where `vec` (r % 4 == 0, B 16-byte aligned), else 4-byte.
__device__ void copy_rows(float* bs, const float* __restrict__ b, long long row0, int nr,
                          int r, int ld, int vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < nr; i += NT / 32) {
    const float* src = b + (row0 + i) * (long long)r;
    float* dst = bs + (long long)i * ld;
    if (vec) {
      for (int j = 4 * lane; j < r; j += 128) cp_async16(dst + j, src + j);
    } else {
      for (int j = lane; j < r; j += 32) cp_async4(dst + j, src + j);
    }
  }
}

// E⁻¹ for this block (cp.async; the caller commits): all of it in full
// mode, else its rows J_b = [rank·js, …) where the layout keeps them on
// chip.  Returns where the solve reads row j0 of its range from (row
// stride r).
__device__ const float* stage_einv(float* es, const Layout& L, const float* __restrict__ einv,
                                   int r, int rank, int vec) {
  const long long first = L.full ? 0 : (long long)rank * L.js;
  const float* rows = einv + first * r;
  if (L.es_len == 0) return rows;
  const int n = L.full ? r * r : max(0, min(L.js, r - rank * L.js)) * r;
  if (vec) {
    for (int e = 4 * threadIdx.x; e < n; e += 4 * NT) cp_async16(es + e, rows + e);
  } else {
    for (int e = threadIdx.x; e < n; e += NT) cp_async4(es + e, rows + e);
  }
  return es;
}

// Thread map of the reduce: lanes over columns j of B in passes of jw,
// G groups over the rows.
struct RMap {
  int jw, groups, passes, jl, g;
};
__device__ inline RMap rmap(int r) {
  RMap m;
  m.jw = min((r + 31) & ~31, NT);
  m.groups = NT / m.jw;
  m.passes = (r + m.jw - 1) / m.jw;
  m.jl = threadIdx.x % m.jw;
  m.g = threadIdx.x / m.jw;
  return m;
}

// acc[c] += Σ_i B[i, j]·w[i, c] over this thread's rows i ≡ g (mod G).
template <int CB>
__device__ __forceinline__ void reduce_rows(const float* bs, int ld, const float* ws,
                                            int nr, int j, int g, int groups,
                                            float (&acc)[CB]) {
  constexpr int P = cbp_of(CB);
#pragma unroll 4
  for (int i = g; i < nr; i += groups) {
    const float bij = bs[i * ld + j];
    float w[CB];
    load_row<CB>(ws + i * P, w);
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[c] = fmaf(bij, w[c], acc[c]);
  }
}

// dst[j, c] (row stride cbp) = the groups' sums for columns j of this pass,
// added in group order.  Every thread of the block calls it.
template <int CB>
__device__ void combine_reduce(const float (&acc)[CB], const RMap& m, int j0, int r,
                               float* gp, float* dst) {
  constexpr int P = cbp_of(CB);
  if (m.groups == 1) {
    if (m.g == 0 && j0 + m.jl < r) {
#pragma unroll
      for (int c = 0; c < CB; ++c) dst[(j0 + m.jl) * P + c] = acc[c];
    }
    return;
  }
  if (m.g < m.groups) {
#pragma unroll
    for (int c = 0; c < CB; ++c) gp[(m.g * m.jw + m.jl) * P + c] = acc[c];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < m.jw * CB; e += NT) {
    const int jl = e / CB, c = e - jl * CB;
    if (j0 + jl >= r) continue;
    float s = gp[jl * P + c];
    for (int q = 1; q < m.groups; ++q) s += gp[(q * m.jw + jl) * P + c];
    dst[(j0 + jl) * P + c] = s;
  }
  __syncthreads();
}

// out rows [row0, row0 + nr) = w − D⁻¹(B s), s [r, cbp] in sf.  A warp
// takes 8 rows at a time: lane l reads row l % 8 at columns j ≡ l / 8
// (mod 4), so its 32 loads of B fall in 32 banks, and the four partial
// sums of a row are added by a fixed butterfly.
template <int CB>
__device__ void expand_rows(const float* bs, int ld, const float* ws, const float* ds,
                            int nr, int r, const float* sf, float* __restrict__ out,
                            long long row0, int ldv, int c0) {
  constexpr int P = cbp_of(CB);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ri = lane & 7, q = lane >> 3;
  for (int i0 = warp * 8; i0 < nr; i0 += NT / 4) {
    const int i = i0 + ri;
    const bool ok = i < nr;
    const float* brow = bs + (long long)(ok ? i : 0) * ld;
    float acc[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[c] = 0.0f;
#pragma unroll 4
    for (int j = q; j < r; j += 4) {
      const float bij = brow[j];
      float s[CB];
      load_row<CB>(sf + j * P, s);
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[c] = fmaf(bij, s[c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 8);
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 16);
    }
    if (q == 0 && ok) {
      float* o = out + (row0 + i) * ldv + c0;
#pragma unroll
      for (int c = 0; c < CB; ++c) o[c] = ws[i * P + c] - ds[i] * acc[c];
    }
  }
}

// full[k, c] = the value of rank ⌊k/js⌋'s slice at row k mod js, read
// through distributed shared memory.
template <int CB>
__device__ void gather_slices(cg::cluster_group& cl, float* slice, float* full, int r, int js) {
  constexpr int P = cbp_of(CB);
  for (int e = threadIdx.x; e < r * CB; e += NT) {
    const int k = e / CB, c = e - k * CB;
    const int q = k / js;
    full[k * P + c] = cl.map_shared_rank(slice, q)[(k - q * js) * P + c];
  }
}

// Rows [j0, j0 + n) of s = E⁻¹u into ss, u [r, cbp] in uf, row j0 of E⁻¹
// at erows.  A warp takes 8 rows; the 4 lanes of a row each sum a quarter
// of k, starting at a lane-dependent offset and wrapping around, so that
// the 32 lanes read 32 banks; a fixed butterfly adds the quarters.
template <int CB>
__device__ void solve_rows(const float* erows, const float* uf, float* ss, int r,
                           int j0, int n) {
  constexpr int P = cbp_of(CB);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rl = lane & 7, ch = lane >> 3;
  const int kc = (r + 3) / 4;
  const int k0 = min(r, ch * kc), len = min(r, k0 + kc) - k0;
  for (int jb = warp * 8; jb < n; jb += NT / 4) {
    const int jl = jb + rl;
    const bool ok = jl < n && j0 + jl < r;
    const float* erow = erows + (long long)(ok ? jl : 0) * r + k0;
    const float* ub = uf + (long long)k0 * P;
    float acc[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[c] = 0.0f;
    const int base = len > 0 ? lane % len : 0;
#pragma unroll 4
    for (int step = 0; step < len; ++step) {
      const int kk = base + step < len ? base + step : base + step - len;
      const float e = erow[kk];
      float u[CB];
      load_row<CB>(ub + kk * P, u);
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[c] = fmaf(e, u[c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 8);
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 16);
    }
    if (ch == 0 && ok) {
#pragma unroll
      for (int c = 0; c < CB; ++c) ss[jl * P + c] = acc[c];
    }
  }
}

// From this block's rows of u (in us) to the whole of s (in the part
// region): gather u, solve this block's rows, share them, gather s.  On
// return this block may still be read by its peers until the caller's
// final cluster_wait.
template <int CB>
__device__ void share_s(cg::cluster_group& cl, const float* erows, const Layout& L,
                        float* sm, int r, int rank) {
  float* full = sm + L.part;
  gather_slices<CB>(cl, sm + L.us, full, r, L.js);
  __syncthreads();
  solve_rows<CB>(erows, full, sm + L.ss, r, rank * L.js, L.js);
  cluster_sync();      // every block's rows of s are written; u is no longer read
  gather_slices<CB>(cl, sm + L.ss, full, r, L.js);
  cluster_arrive();    // this block reads no peer after this point
  __syncthreads();
}

// Launch 1: block p writes its rows' [r, cbp] partial of
// Bᵀw to part[p], streaming B in tiles of `tile` rows (cp.async, two
// stages).
template <int CB>
__global__ void __launch_bounds__(NT, 1)
    wb_partials(const float* __restrict__ b, const float* __restrict__ dinv,
                const float* __restrict__ v, float* __restrict__ part,
                long long t, int r, int ldv, int c0, int rows, int tile, int vec) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Layout L = layout(2 * tile, r, CB);
  const long long row0 = (long long)blockIdx.x * rows;
  const long long left = t - row0;
  const int nr = left <= 0 ? 0 : (left < rows ? (int)left : rows);
  const int ntiles = (nr + tile - 1) / tile;
  constexpr int P = cbp_of(CB);
  float* dst = part + (long long)blockIdx.x * r * P;
  const RMap m = rmap(r);
  for (int pass = 0; pass < m.passes; ++pass) {
    const int j0 = pass * m.jw;
    float acc[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[c] = 0.0f;
    for (int k = 0; k < ntiles; ++k) {
      const long long rk = row0 + (long long)k * tile;
      const int slot = k & 1;
      if (k == 0) {
        copy_rows(sm + L.b, b, rk, min(tile, nr), r, L.ld, vec);
        cp_async_commit();
        stage_w<CB>(sm + L.w, sm + L.d, dinv, v, rk, min(tile, nr), ldv, c0);
      }
      if (k + 1 < ntiles) {
        const int nxt = 1 - slot, n_next = min(tile, nr - (k + 1) * tile);
        copy_rows(sm + L.b + (long long)nxt * tile * L.ld, b, rk + tile, n_next, r, L.ld,
                  vec);
        cp_async_commit();
        stage_w<CB>(sm + L.w + nxt * tile * P, sm + L.d + nxt * tile, dinv, v, rk + tile,
                    n_next, ldv, c0);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (m.g < m.groups && j0 + m.jl < r)
        reduce_rows<CB>(sm + L.b + (long long)slot * tile * L.ld, L.ld,
                        sm + L.w + slot * tile * P, min(tile, nr - k * tile), j0 + m.jl,
                        m.g, m.groups, acc);
      __syncthreads();   // the slot is refilled next iteration
    }
    combine_reduce<CB>(acc, m, j0, r, sm + L.gp, dst);
  }
}

// Launch 2: clusters of 16 blocks; each block (full mode)
// or each cluster sums the `np` partials (in partial order) for its own
// copy of u and s, and block (k, b) expands rows [(16k + b)·rows, …),
// streaming B in tiles.
template <int CB>
__global__ void __launch_bounds__(NT, 1)
    wb_finish(const float* __restrict__ b, const float* __restrict__ dinv,
              const float* __restrict__ einv, const float* __restrict__ v,
              const float* __restrict__ part, float* __restrict__ out, long long t,
              int r, int ldv, int c0, int np, int rows, int tile, int vec) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cl = cg::this_cluster();
  constexpr int P = cbp_of(CB);
  const int rank = (int)cl.block_rank();
  const Layout L = layout(2 * tile, r, CB);
  const long long row0 = (long long)blockIdx.x * rows;
  const long long left = t - row0;
  const int nr = left <= 0 ? 0 : (left < rows ? (int)left : rows);
  const int ntiles = (nr + tile - 1) / tile;
  // E⁻¹ and the first tile's copy overlap the sums below.
  const float* erows = stage_einv(sm + L.es, L, einv, r, rank, vec);
  copy_rows(sm + L.b, b, row0, min(tile, nr), r, L.ld, vec);
  cp_async_commit();
  stage_w<CB>(sm + L.w, sm + L.d, dinv, v, row0, min(tile, nr), ldv, c0);

  // Entries of u = Σ_p part[p] (all of them in full mode, else rows J_b):
  // `groups` thread groups each sum a run of partials in order, then the
  // runs are added in order.
  const int first = L.full ? 0 : rank * L.js;
  const int nrows = L.full ? r : max(0, min(L.js, r - first));
  float* ud = L.full ? sm + L.part : sm + L.us;
  float* gp = sm + L.gp;
  const int ent = nrows * CB;
  const int groups = max(1, min(np, NT / max(ent, 1)));
  const int per = (np + groups - 1) / groups;
  const long long stride = (long long)r * P;
  for (int e0 = 0; e0 < ent; e0 += NT) {
    const int e = e0 + threadIdx.x % ent, q = threadIdx.x / ent;
    if (e < ent && q < groups) {
      const int jl = e / CB, c = e - jl * CB;
      const float* src = part + (long long)(first + jl) * P + c;
      float s = 0.0f;
      const int p1 = min(np, (q + 1) * per);
#pragma unroll 8
      for (int p = q * per; p < p1; ++p) s += src[p * stride];
      gp[q * ent + e] = s;
    }
    __syncthreads();
    const int e2 = e0 + threadIdx.x;
    if ((int)threadIdx.x < ent && e2 < ent) {
      const int jl2 = e2 / CB, c2 = e2 - jl2 * CB;
      float s = gp[e2];
      for (int q2 = 1; q2 < groups; ++q2) s += gp[q2 * ent + e2];
      ud[jl2 * P + c2] = s;
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // E⁻¹ (and the first tile) are on chip
  const float* s_all;
  if (L.full) {
    __syncthreads();
    solve_rows<CB>(erows, ud, sm + L.sf, r, 0, r);
    s_all = sm + L.sf;
  } else {
    cluster_sync();    // every row of u is written
    share_s<CB>(cl, erows, L, sm, r, rank);
    s_all = sm + L.part;
  }
  for (int k = 0; k < ntiles; ++k) {
    const long long rk = row0 + (long long)k * tile;
    const int slot = k & 1;
    if (k + 1 < ntiles) {
      const int nxt = 1 - slot, n_next = min(tile, nr - (k + 1) * tile);
      copy_rows(sm + L.b + (long long)nxt * tile * L.ld, b, rk + tile, n_next, r, L.ld,
                vec);
      cp_async_commit();
      stage_w<CB>(sm + L.w + nxt * tile * P, sm + L.d + nxt * tile, dinv, v, rk + tile,
                  n_next, ldv, c0);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    expand_rows<CB>(sm + L.b + (long long)slot * tile * L.ld, L.ld,
                    sm + L.w + slot * tile * P, sm + L.d + slot * tile,
                    min(tile, nr - k * tile), r, s_all, out, rk, ldv, c0);
    __syncthreads();   // the slot is refilled next iteration
  }
  if (!L.full) cluster_wait();
}

template <typename K, typename... Args>
static cudaError_t launch_ex(K kernel, unsigned int blocks, int cluster, size_t smem,
                             cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Both launches at CB columns.  The 227 KB shared-memory attribute (and,
// for wb_finish, the non-portable cluster size) is set once per
// device and instance, on its first call there.
template <int CB>
static cudaError_t run(const float* b, const float* dinv, const float* einv,
                       const float* v, float* out, float* part, long long t, int r,
                       int ldv, int c0, int rows, int tile, int np, int nclus,
                       int rows_f, cudaStream_t st) {
  // 16-byte copies need 16-byte rows of B and of E⁻¹.
  const int vec = r % 4 == 0 && ((uintptr_t)b & 15) == 0 && ((uintptr_t)einv & 15) == 0;
  static unsigned int ready = 0u;   // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !((ready >> dev) & 1u)) {
    err = cudaFuncSetAttribute((const void*)wb_partials<CB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute((const void*)wb_finish<CB>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute((const void*)wb_finish<CB>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    if (dev < 32) ready |= 1u << dev;
  }
  const size_t smem = (size_t)layout(2 * tile, r, CB).total * 4;
  if (smem > SMEM_LIMIT || np < 1 || nclus < 1) return cudaErrorInvalidValue;
  err = launch_ex(wb_partials<CB>, (unsigned int)np, 1, smem, st, b, dinv, v, part, t, r,
                  ldv, c0, rows, tile, vec);
  if (err != cudaSuccess) return err;
  return launch_ex(wb_finish<CB>, (unsigned int)(nclus * CLUSTER), CLUSTER, smem, st, b,
                   dinv, einv, v, (const float*)part, out, t, r, ldv, c0, np, rows_f,
                   tile, vec);
}

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Columns [c0, c0 + cb) of out = M⁻¹v, v and out [t, ldv] row-major: np
// blocks of `rows` rows write partials to `part` (np·r·cbp floats), then
// nclus clusters expand `rows_f` rows a block; B streams in `tile`-row
// tiles.  ops.py::plan computes every one of these.
int woodbury_apply_launch(const void* b, const void* dinv, const void* einv,
                          const void* v, void* out, void* part, long long t, int r,
                          int ldv, int c0, int cb, int rows, int tile, int np,
                          int nclus, int rows_f, void* stream) {
  if (t == 0) return (int)cudaSuccess;
  if (r < 1 || r > MAX_RANK || cb < 1 || cb > MAX_CB) return (int)cudaErrorInvalidValue;
  const float* B = (const float*)b;
  const float* Di = (const float*)dinv;
  const float* Ei = (const float*)einv;
  const float* V = (const float*)v;
  float* O = (float*)out;
  float* Pt = (float*)part;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  switch (cb) {
#define WB_CASE(N)                                                                 \
  case N:                                                                          \
    err = run<N>(B, Di, Ei, V, O, Pt, t, r, ldv, c0, rows, tile, np, nclus, rows_f, \
                 st);                                                              \
    break;
    WB_CASE(1) WB_CASE(2) WB_CASE(3) WB_CASE(4) WB_CASE(5) WB_CASE(6) WB_CASE(7)
    WB_CASE(8) WB_CASE(9) WB_CASE(10) WB_CASE(11) WB_CASE(12) WB_CASE(13)
    WB_CASE(14) WB_CASE(15) WB_CASE(16)
#undef WB_CASE
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
