// Sparse×sparse cross-Gram block G = Φ_rows Φ_colsᵀ for sm_90a:
//   G[i, j] = Σ_k Σ_l vals_r[i,k]·vals_c[j,l]·[cols_r[i,k] == cols_c[j,l]].
//
// Replaces the TPU kernel src/repro/kernels/gram_block/gram_block.py:59
// `gram_block` (pallas_call at :80, body `_gram_kernel` :39).  Plain
// versions: repro_torch/kernels/gram_block/ref.py `gram_block_ref` (the
// function) and `aggregate_rows_ref` (this kernel's first step).
//
// What bounds it on this card: bytes.  G needs one multiply-add per pair of
// non-zero slots on the same column, Σ_col nnz_r(col)·nnz_c(col), few on
// graph-local walks, against (M_r·K_r + M_c·K_c)·8 + M_r·M_c·4 bytes moved.
// Nothing is N-long.  Comparing every slot pair instead would cost
// M_r·M_c·K_r·K_c compares (5.4·10⁹ for the 512×512 Thompson Gram at
// K = 144).
//
// Design.  A walk row is mostly repeats: 18.5 distinct columns in 144 slots
// at the serving width.  With A_i(c) = Σ_{k: c_k = c} vals_r[i,k] (and B_j
// likewise), G[i, j] = Σ_c A_i(c)·B_j(c) exactly, up to the order of the sum,
// so the work follows the distinct columns:
//   aggregate  one warp per row of either side turns the row into its
//              distinct (column, Σ value) entries, in order of first
//              occurrence, skipping ±0 values (exact for finite payloads):
//              32 slots at a time, __match_any_sync groups equal columns,
//              the group's lowest lane sums them in slot order and adds the
//              sum to the column's entry in the row's list in shared memory
//              (a scan of the ≈18 entries so far), or appends a new one;
//   probe      the side with fewer rows is "hashed": a block holds up to 32
//              of its aggregated rows as open-addressing hash tables in
//              shared memory (padded so that 32 lanes probing one column
//              hit 32 banks), each built by one warp in rounds: every lane
//              whose slot is free writes its column there, the column that
//              stays keeps the slot, the others move on.  The block's warps
//              take rows of the other side; a lane is (entry group, table):
//              with 32 tables, lane j looks each of the probe row's entries
//              up in table j; with fewer (the Nyström column hashes one
//              row), the groups split the entries and meet in a fixed
//              butterfly.  Work: M_r·M_c·(distinct entries) probes, not
//              M_r·M_c·K_r·K_c compares.
// The hashed side is the one with fewer rows, so that the skinny calls fill
// the card: the Nyström pivot column ([4000, 144] × [1, 144]) builds one
// table per block and spreads the 4000 probe rows over the card; one
// serving append ([1, 144] × [128, 144]) hashes its one row.  The grid is
// hashed tiles × probe slices, and a warp strides over its slice's rows, so
// neither M_r nor M_c meets a grid-dimension limit.  No atomics: every sum
// runs in an order fixed by the inputs, so two calls give bit-equal G (a
// table's layout may differ between calls; what a lookup returns does
// not).  The aggregated rows go through a scratch buffer that the wrapper
// allocates.
#include <cuda_runtime.h>

#define WARPS 16
#define FULL 0xffffffffu
#define EMPTY (-1)            // a free table slot; columns are node ids ≥ 0
#define MAX_TILE 32           // hashed rows per block: one per lane
#define TABLE_BYTES (72 << 10)   // 32 tables at K = 144, 3 blocks an SM
#define PRELOAD 5             // chunks of 32 slots loaded at once (K = 144)

__device__ __forceinline__ unsigned slot_of(int key, int shift) {
  return ((unsigned)key * 0x9E3779B1u) >> shift;   // Fibonacci hashing
}

// One chunk of 32 slots (one per lane) into a row's entry list lcol/lsum of
// n entries: equal columns are summed in slot order by their lowest lane,
// which adds the sum to the column's entry or appends a new one.
__device__ __forceinline__ void aggregate_chunk(float val, int col, int lane,
                                                float* stage, int* lcol,
                                                float* lsum, int& n) {
  const bool live = val != 0.0f;
  const int key = live ? col : -2 - lane;   // a dead lane groups alone
  const unsigned peers = __match_any_sync(FULL, key);
  const bool leader = live && (__ffs(peers) - 1 == lane);
  stage[lane] = val;
  __syncwarp();
  float s = 0.0f;
  if (leader)
    for (unsigned m = peers; m; m &= m - 1) s += stage[__ffs(m) - 1];
  int at = -1;   // the column's entry from an earlier chunk, if any
  for (int e = 0; e < n; ++e)
    if (lcol[e] == key) at = e;
  if (leader && at >= 0) lsum[at] += s;   // one leader per column
  const unsigned fresh = __ballot_sync(FULL, leader && at < 0);
  if (leader && at < 0) {   // new columns join the list in slot order
    const int pos = n + __popc(fresh & ((1u << lane) - 1u));
    lcol[pos] = key;
    lsum[pos] = s;
  }
  n += __popc(fresh);
  __syncwarp();
}

// Each row of both payloads into its distinct (column, Σ value) entries,
// in order of first occurrence, with counts into cnt_r / cnt_c.  A row's
// entries are followed by padding (column EMPTY, value 0) up to a multiple
// of 32 (at least 32, at most the row's K), so that a reader of the first
// 32 entries needs no count.  Shared memory per warp: the row's entry list,
// columns and sums (k_max each), and a stage of 32 values.
__global__ void __launch_bounds__(WARPS * 32)
    gram_aggregate(const float* __restrict__ vals_r,
                   const int* __restrict__ cols_r, long long m_r, int k_r,
                   const float* __restrict__ vals_c,
                   const int* __restrict__ cols_c, long long m_c, int k_c,
                   int* __restrict__ acols_r, float* __restrict__ avals_r,
                   int* __restrict__ cnt_r, int* __restrict__ acols_c,
                   float* __restrict__ avals_c, int* __restrict__ cnt_c) {
  extern __shared__ int smem[];
  const int k_max = k_r > k_c ? k_r : k_c;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int* lcol = smem + w * (2 * k_max + 32);
  float* lsum = reinterpret_cast<float*>(lcol + k_max);
  float* stage = lsum + k_max;
  for (long long t = (long long)blockIdx.x * nwarps + w; t < m_r + m_c;
       t += (long long)gridDim.x * nwarps) {
    const bool side_r = t < m_r;
    const long long row = side_r ? t : t - m_r;
    const int k = side_r ? k_r : k_c;
    const float* vrow = (side_r ? vals_r : vals_c) + row * k;
    const int* crow = (side_r ? cols_r : cols_c) + row * k;
    // The row's first PRELOAD chunks are loaded at once, the rest as needed.
    float pv[PRELOAD];
    int pc[PRELOAD];
#pragma unroll
    for (int q = 0; q < PRELOAD; ++q) {
      const bool in = q * 32 + lane < k;
      pv[q] = in ? vrow[q * 32 + lane] : 0.0f;
      pc[q] = in ? crow[q * 32 + lane] : 0;
    }
    int n = 0;
#pragma unroll
    for (int q = 0; q < PRELOAD; ++q) {
      if (q * 32 >= k) break;
      aggregate_chunk(pv[q], pc[q], lane, stage, lcol, lsum, n);
    }
    for (int c0 = PRELOAD * 32; c0 < k; c0 += 32) {
      const bool in = c0 + lane < k;
      aggregate_chunk(in ? vrow[c0 + lane] : 0.0f, in ? crow[c0 + lane] : 0,
                      lane, stage, lcol, lsum, n);
    }
    int written = (n + 31) & ~31;
    if (written < 32) written = 32;
    if (written > k) written = k;
    int* oc = (side_r ? acols_r : acols_c) + row * k;
    float* ov = (side_r ? avals_r : avals_c) + row * k;
    for (int e = lane; e < written; e += 32) {
      oc[e] = e < n ? lcol[e] : EMPTY;
      ov[e] = e < n ? lsum[e] : 0.0f;
    }
    if (lane == 0) (side_r ? cnt_r : cnt_c)[row] = n;
    __syncwarp();
  }
}

// Insert one entry per lane (distinct columns, `todo` lanes only) into a
// table by linear probing, in rounds: every lane whose slot is free writes
// its column there, the column that stays is the slot's, and the others
// move on.  Which of two lanes keeps a slot may differ between calls; a
// lookup finds each column wherever it went, so G does not.  No atomics.
__device__ __forceinline__ void insert_lanes(int* tk, float* ts, int c, float v,
                                             bool todo, int cap, int shift) {
  unsigned p = todo ? slot_of(c, shift) : 0u;
  while (__any_sync(FULL, todo)) {
    const bool open = todo && tk[p] == EMPTY;
    __syncwarp();
    if (open) tk[p] = c;
    __syncwarp();
    if (open && tk[p] == c) {
      ts[p] = v;
      todo = false;
    } else if (todo) {
      p = (p + 1) & (cap - 1);
    }
    __syncwarp();
  }
}

// The value of column col in a table, 0 where it is absent.
__device__ __forceinline__ float lookup(const int* tk, const float* ts, int col,
                                        int cap, int shift) {
  unsigned h = slot_of(col, shift);
  int kh = tk[h];
  while (kh != col && kh != EMPTY) {
    h = (h + 1) & (cap - 1);
    kh = tk[h];
  }
  return kh == col ? ts[h] : 0.0f;
}

// G entries for a tile of `tile` hashed rows (blockIdx.x) against the probe
// rows of slice blockIdx.y: G[hashed j, probe i] is out[j·out_h + i·out_p].
__global__ void __launch_bounds__(WARPS * 32)
    gram_probe(const int* __restrict__ hcols, const float* __restrict__ hvals,
               const int* __restrict__ hcnt, long long m_h, int k_h,
               const int* __restrict__ pcols, const float* __restrict__ pvals,
               const int* __restrict__ pcnt, long long m_p, int k_p,
               float* __restrict__ out, long long out_h, long long out_p,
               int tile, int bits) {
  constexpr int TPW = MAX_TILE / WARPS;   // tables a warp builds
  extern __shared__ int smem[];
  const int cap = 1 << bits, shift = 32 - bits;
  // One word of padding after each table: the lanes of a warp look one
  // column up in 32 tables at once, and land in 32 different banks.
  const int stride = cap + 1;
  int* keys = smem;                                             // [tile][stride]
  float* sums = reinterpret_cast<float*>(smem + tile * stride); // [tile][stride]
  const long long j0 = (long long)blockIdx.x * tile;
  const int nh = (int)(m_h - j0 < tile ? m_h - j0 : tile);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int h = threadIdx.x; h < tile * stride; h += blockDim.x) keys[h] = EMPTY;
  // Warp w builds tables w, w + nwarps, ...: the first 32 entries of each
  // are loaded together (padding marks the end), then inserted.
  int c[TPW], n[TPW];
  float v[TPW];
#pragma unroll
  for (int q = 0; q < TPW; ++q) {
    const int j = w + q * nwarps;
    c[q] = EMPTY;
    v[q] = 0.0f;
    n[q] = 0;
    if (j < nh) {
      const long long row = j0 + j;
      n[q] = hcnt[row];
      if (lane < k_h) {
        c[q] = hcols[row * k_h + lane];
        v[q] = hvals[row * k_h + lane];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < TPW; ++q) {
    const int j = w + q * nwarps;
    if (j >= nh) continue;
    int* tk = keys + j * stride;
    float* ts = sums + j * stride;
    insert_lanes(tk, ts, c[q], v[q], c[q] != EMPTY, cap, shift);
    const long long row = j0 + j;
    for (int c0 = 32; c0 < n[q]; c0 += 32) {
      const bool todo = c0 + lane < n[q];
      insert_lanes(tk, ts, todo ? hcols[row * k_h + c0 + lane] : EMPTY,
                   todo ? hvals[row * k_h + c0 + lane] : 0.0f, todo, cap,
                   shift);
    }
  }
  __syncthreads();
  // Lane = (entry group g, table j): with tp ≥ nh tables in use, the 32/tp
  // groups split a probe row's entries, so that a small tile (the Nyström
  // column's one row) still puts every lane to work.
  const int tp = nh > 16 ? 32 : nh > 8 ? 16 : nh > 4 ? 8 : nh > 2 ? 4 : nh > 1 ? 2 : 1;
  const int groups = 32 / tp, g = lane / tp, j = lane - g * tp;
  const bool mine = j < nh;
  const int* tk = keys + (mine ? j : 0) * stride;
  const float* ts = sums + (mine ? j : 0) * stride;
  for (long long i = (long long)blockIdx.y * nwarps + w; i < m_p;
       i += (long long)gridDim.y * nwarps) {
    const int* rc = pcols + i * k_p;
    const float* rv = pvals + i * k_p;
    int mc = EMPTY;   // the first 32 entries need no count (padding)
    float mv = 0.0f;
    if (lane < k_p) {
      mc = rc[lane];
      mv = rv[lane];
    }
    const int n_i = pcnt[i];
    float acc = 0.0f;
    for (int c0 = 0; c0 < n_i; c0 += 32) {
      if (c0 > 0) {
        mc = c0 + lane < n_i ? rc[c0 + lane] : EMPTY;
        mv = c0 + lane < n_i ? rv[c0 + lane] : 0.0f;
      }
      const int m = n_i - c0 < 32 ? n_i - c0 : 32;
      for (int e = g; e - g < m; e += groups) {   // the same trips on every lane
        const int col = __shfl_sync(FULL, mc, e);
        const float val = __shfl_sync(FULL, mv, e);
        if (mine && e < m) acc += val * lookup(tk, ts, col, cap, shift);
      }
    }
    for (int off = tp; off < 32; off <<= 1)   // the groups' sums, in a fixed order
      acc += __shfl_xor_sync(FULL, acc, off);
    if (mine && g == 0) out[(j0 + j) * out_h + i * out_p] = acc;
  }
}

static int log2_ceil(long long x) {
  int b = 0;
  while ((1LL << b) < x) ++b;
  return b;
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

// Opt a kernel into `bytes` of dynamic shared memory past the default 48 KB,
// with the SM's memory split in favour of shared memory, so that as many
// blocks fit on an SM as their shared memory allows.
static cudaError_t allow_smem(const void* fn, int bytes, int* allowed) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

// allow_smem for a kernel that gram_block_launch also opts in, which keeps
// its own record of what it set: read the kernel's limit and only ever
// raise it, so that neither entry lowers it below what the other relies on.
static cudaError_t raise_smem(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess || attr.maxDynamicSharedSizeBytes >= bytes) return err;
  int allowed = 0;
  return allow_smem(fn, bytes, &allowed);
}

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// scratch: 2·(m_r·k_r + m_c·k_c) + m_r + m_c int32 words, for the
// aggregated rows (columns, sums) and their entry counts.
int gram_block_launch(const void* vals_r, const void* cols_r,
                      const void* vals_c, const void* cols_c, void* out,
                      void* scratch, long long m_r, int k_r, long long m_c,
                      int k_c, void* stream) {
  if (m_r < 0 || m_c < 0 || k_r < 0 || k_c < 0)
    return (int)cudaErrorInvalidValue;
  if (m_r == 0 || m_c == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInitializationError;
  static int agg_allowed = 0, probe_allowed = 0;

  int* acols_r = (int*)scratch;
  float* avals_r = (float*)(acols_r + m_r * k_r);
  int* acols_c = (int*)(avals_r + m_r * k_r);
  float* avals_c = (float*)(acols_c + m_c * k_c);
  int* cnt_r = (int*)(avals_c + m_c * k_c);
  int* cnt_c = cnt_r + m_r;

  // Aggregation.
  const int k_max = k_r > k_c ? k_r : k_c;
  const int per_warp = (2 * k_max + 32) * (int)sizeof(int);
  int warps = (200 << 10) / per_warp;
  if (warps > WARPS) warps = WARPS;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem((const void*)gram_aggregate, warps * per_warp,
                               &agg_allowed);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (m_r + m_c + warps - 1) / warps;
  if (blocks > 32LL * sms) blocks = 32LL * sms;
  gram_aggregate<<<(unsigned int)blocks, warps * 32, warps * per_warp, s>>>(
      (const float*)vals_r, (const int*)cols_r, m_r, k_r, (const float*)vals_c,
      (const int*)cols_c, m_c, k_c, acols_r, avals_r, cnt_r, acols_c, avals_c,
      cnt_c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // Probe: hash the side with fewer rows (the columns on a tie).
  const bool hash_c = m_c <= m_r;
  const long long m_h = hash_c ? m_c : m_r, m_p = hash_c ? m_r : m_c;
  const int k_h = hash_c ? k_c : k_r, k_p = hash_c ? k_r : k_c;
  int bits = log2_ceil((long long)k_h + 1);   // tables at most k_h/(k_h+1) full
  if (bits < 1) bits = 1;
  const int table = 2 * ((1 << bits) + 1) * (int)sizeof(int);   // keys + sums
  int tile = TABLE_BYTES / table;
  if (tile > MAX_TILE) tile = MAX_TILE;
  if (tile > m_h) tile = (int)m_h;
  if (tile < 1) {
    if (table > 227 * 1024) return (int)cudaErrorInvalidValue;
    tile = 1;
  }
  err = allow_smem((const void*)gram_probe, tile * table, &probe_allowed);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (m_h + tile - 1) / tile;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  long long slices = (4LL * sms + tiles - 1) / tiles;
  const long long most = (m_p + WARPS - 1) / WARPS;
  if (slices > most) slices = most;
  if (slices > 65535) slices = 65535;
  if (slices < 1) slices = 1;
  const long long out_h = hash_c ? 1 : m_c, out_p = hash_c ? m_c : 1;
  gram_probe<<<dim3((unsigned int)tiles, (unsigned int)slices), WARPS * 32,
               tile * table, s>>>(
      hash_c ? acols_c : acols_r, hash_c ? avals_c : avals_r,
      hash_c ? cnt_c : cnt_r, m_h, k_h, hash_c ? acols_r : acols_c,
      hash_c ? avals_r : avals_c, hash_c ? cnt_r : cnt_c, m_p, k_p,
      (float*)out, out_h, out_p, tile, bits);
  return (int)cudaGetLastError();
}

// One payload [m, k] aggregated alone: gram_aggregate with no column side.
// acols/avals are [m, k] (each row's entries, then padding up to a
// multiple of 32, at least 32 and at most k; entries past that are not
// written), cnt is [m].
int gram_aggregate_launch(const void* vals, const void* cols, void* acols,
                          void* avals, void* cnt, long long m, int k,
                          void* stream) {
  if (m < 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInitializationError;
  const int per_warp = (2 * k + 32) * (int)sizeof(int);
  int warps = (200 << 10) / per_warp;
  if (warps > WARPS) warps = WARPS;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err = raise_smem((const void*)gram_aggregate,
                                     warps * per_warp);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (m + warps - 1) / warps;
  if (blocks > 32LL * sms) blocks = 32LL * sms;
  gram_aggregate<<<(unsigned int)blocks, warps * 32, warps * per_warp,
                   (cudaStream_t)stream>>>(
      (const float*)vals, (const int*)cols, m, k, nullptr, nullptr, 0, 0,
      (int*)acols, (float*)avals, (int*)cnt, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

}  // extern "C"
