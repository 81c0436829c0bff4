// GRF walk sampling (paper Alg. 1/2) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/walk_sampler/walk_sampler.py:59
// `walk_sample` (pallas_call at :92, body `_walk_kernel` :39 running
// ref.walk_block, ref.py:34).  Plain version: repro_torch/kernels/
// walk_sampler/ref.py.
//
// What bounds it on this card: the bytes it writes.  Every (start node,
// walker) emits l_max+1 (col, load, len) triples — 3·M·K·4 bytes for
// K = n_walkers·(l_max+1) — against ≈12 bytes per step of adjacency reads.
// The TPU kernel kept the whole adjacency resident in VMEM; an SM has
// 227 KB, so here the adjacency stays in global memory and the random
// neighbour gathers go through L1/L2 (a ring of 10⁶ nodes is 52 MB of
// adjacency, about the size of L2).
//
// Design.  One thread per (start node, walker), numbered walker-fastest,
// the l_max+1 steps in registers.  Slot (m, w, l) of the [M, K] outputs is
// flat index (m·n_walkers + w)·(l_max+1) + l, so the threads of a block own
// one contiguous run of nt·(l_max+1) slots.  A thread's deposits go to
// shared memory first; after one __syncthreads the block writes its run of
// `cols` and `loads` with 16-byte vector stores (every warp store covers
// 512 contiguous bytes), and `lens`, which is the slot's step index, straight
// from registers the same way.  Writing each slot from its walker instead
// strode a warp's stores 4·(l_max+1) bytes apart, rewriting the same sectors
// at every step.  Indices are 32-bit while M·K < 2³¹ (10⁷ rows × 144 slots
// is 1.44·10⁹) and 64-bit beyond; the walker hash's first two rounds depend
// on (seed, node, walker) only and are computed once per walk.
//
// The chunked Φ products want each slot's feature value load·f[step], not
// the (load, step) pair.  The `Vals` instance (walk_sample_vals_launch)
// stages (load·inv_n)·f[step] where the other stages the load, writes it
// through `loads` and writes no `lens`: 8 bytes a slot instead of 12, and no
// elementwise pass over the chunk afterwards.  Walks of rows at or past the
// valid count (a padded last chunk) run as usual and deposit 0.
//
// Bit-exactness with the JAX reference: XLA compiles the reference's
// division by the constant (1 − p_halt) and by n_walkers into
// multiplications by the float32 reciprocals, so a move is
// ((load·d)·inv_c)·w and a deposit is (load·alive[·w_l])·inv_n, with
// inv_c, inv_n and the grfspp weights w_l = f32((1−p)^l) computed on the
// host.  No add follows a multiply, so nvcc has nothing to contract into
// an FMA; do not build with --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_STEPS 64
#define MAX_THREADS 256
#define STAGE_SLOTS 6144  // slots a block stages: 48 KB of (col, load) pairs

struct StepWeights {
  float w[MAX_STEPS];
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The counter hash of rng.py is fmix(prefix(seed, node, walker) ^ ctr·M3);
// the prefix is the part that does not depend on the counter.
__device__ __forceinline__ uint32_t hash_prefix(uint32_t seed, uint32_t node,
                                                uint32_t walker) {
  uint32_t h = seed ^ 0x9E3779B9u;
  h = fmix32(h ^ (node * 0x85EBCA6Bu));
  return fmix32(h ^ (walker * 0xC2B2AE35u));
}

__device__ __forceinline__ uint32_t hash_ctr(uint32_t prefix, uint32_t ctr) {
  return fmix32(prefix ^ (ctr * 0x27D4EB2Fu));
}

__device__ __forceinline__ float to_uniform(uint32_t bits) {
  // Top 24 bits, exact in float32, times 2^-24.
  return __uint2float_rn(bits >> 8) * 5.9604644775390625e-08f;
}

enum Scheme { IID = 0, ANTITHETIC = 1, QMC = 2, GRFSPP = 3 };

// Vals: `loads` receives load·f[step] (0 for walks at or past valid_walks)
// and `lens` is not written.
template <typename Idx, bool Vals>
__global__ void __launch_bounds__(MAX_THREADS) walk_sample_kernel(
    const int* __restrict__ nbr, const float* __restrict__ wgt,
    const int* __restrict__ deg, const int* __restrict__ nodes,
    int* __restrict__ cols, float* __restrict__ loads, int* __restrict__ lens,
    Idx walks, int max_deg, int n_walkers, int steps, uint32_t seed,
    int scheme, int reweight, float inv_c, float p_halt, float inv_n,
    StepWeights sw, const float* __restrict__ f, Idx valid_walks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x;
  int* cs = reinterpret_cast<int*>(smem);     // [nt · steps] cols
  float* ls = reinterpret_cast<float*>(cs + nt * steps);  // loads
  const Idx w0 = (Idx)blockIdx.x * (Idx)nt;   // first walk of the block
  const Idx left = walks - w0;
  const int nvalid = left < (Idx)nt ? (int)left : nt;

  if ((int)threadIdx.x < nvalid) {
    const Idx tid = w0 + threadIdx.x;
    const Idx m = tid / (Idx)n_walkers;
    const uint32_t walker = (uint32_t)(tid - m * (Idx)n_walkers);
    const int start = nodes[m];
    const uint32_t node_u = (uint32_t)start;
    const uint32_t pre_move = hash_prefix(seed, node_u, walker);
    uint32_t pre_halt = pre_move;
    if (scheme == ANTITHETIC) pre_halt = hash_prefix(seed, node_u, walker & 0xFFFFFFFEu);
    if (scheme == QMC) pre_halt = hash_prefix(seed, node_u, 0xFFFFFFFFu);
    const uint32_t qmc_point = __brev(walker);
    int* my_c = cs + threadIdx.x * steps;
    float* my_l = ls + threadIdx.x * steps;

    bool live = true;
    if constexpr (Vals) live = tid < valid_walks;

    int cur = start;
    float load = 1.0f, alive = 1.0f;
    for (int step = 0; step < steps; ++step) {
      my_c[step] = cur;
      float dep = load * alive;
      if (scheme == GRFSPP) dep = dep * sw.w[step];
      if constexpr (Vals) {
        // Two products, as (loads * valid) * f[lens] forms them.
        const float dn = dep * inv_n;
        my_l[step] = live ? dn * __ldg(f + step) : 0.0f;
      } else {
        my_l[step] = dep * inv_n;
      }

      const float u = to_uniform(hash_ctr(pre_move, 2u * step));
      const int d = deg[cur];
      // Degree 0: choice 0 lands on the zero padding, as in ref.py.
      const int choice = min((int)(u * (float)d), max(d - 1, 0));
      // The adjacency is N·max_deg entries, counted apart from M·K.
      const size_t flat = (size_t)(unsigned int)cur * (unsigned int)max_deg + choice;
      const int nxt = nbr[flat];
      const float w = wgt[flat];
      load = reweight ? ((load * (float)d) * inv_c) * w : load * w;
      if (scheme != GRFSPP) {
        const uint32_t hb = hash_ctr(pre_halt, 2u * step + 1u);
        float uh;
        if (scheme == ANTITHETIC) {
          const float ua = to_uniform(hb);
          uh = (walker & 1u) ? 1.0f - ua : ua;
        } else if (scheme == QMC) {
          uh = to_uniform(qmc_point ^ hb);
        } else {
          uh = to_uniform(hb);
        }
        alive = alive * (uh >= p_halt ? 1.0f : 0.0f);
      }
      alive = alive * (d > 0 ? 1.0f : 0.0f);
      cur = nxt;
    }
  }
  __syncthreads();

  // The block's run of slots: [w0·steps, (w0 + nvalid)·steps).  w0·steps is
  // a multiple of 32 slots (nt is a multiple of 32), so the run starts on a
  // 16-byte boundary of each output.
  const Idx base = w0 * (Idx)steps;
  const int n = nvalid * steps;
  const int n4 = n >> 2;
  int4* c4 = reinterpret_cast<int4*>(cols + base);
  float4* l4 = reinterpret_cast<float4*>(loads + base);
  int4* s4 = reinterpret_cast<int4*>(lens + base);
  const int4* cs4 = reinterpret_cast<const int4*>(cs);
  const float4* ls4 = reinterpret_cast<const float4*>(ls);
  for (int q = threadIdx.x; q < n4; q += nt) {
    c4[q] = cs4[q];
    l4[q] = ls4[q];
    if constexpr (!Vals) {
      const int l0 = (4 * q) % steps;
      const int l1 = l0 + 1 == steps ? 0 : l0 + 1;
      const int l2 = l1 + 1 == steps ? 0 : l1 + 1;
      const int l3 = l2 + 1 == steps ? 0 : l2 + 1;
      s4[q] = make_int4(l0, l1, l2, l3);
    }
  }
  for (int e = 4 * n4 + threadIdx.x; e < n; e += nt) {
    cols[base + e] = cs[e];
    loads[base + e] = ls[e];
    if constexpr (!Vals) lens[base + e] = e % steps;
  }
}

// Threads per block for walks of `steps` slots: 256, or fewer (a multiple
// of 32) so that the staged slots fit in 48 KB of shared memory.
static int walk_sample_threads(int steps) {
  int nt = (STAGE_SLOTS / steps) & ~31;
  return nt < MAX_THREADS ? nt : MAX_THREADS;
}

template <bool Vals>
static int launch(const void* nbr, const void* wgt, const void* deg,
                  const void* nodes, const void* f, void* cols, void* loads,
                  void* lens, long long m_rows, long long n_valid, int max_deg,
                  int n_walkers, int l_max, unsigned int seed, int scheme,
                  int reweight, float inv_c, float p_halt, float inv_n,
                  const float* step_weights, void* stream) {
  if (l_max + 1 > MAX_STEPS || n_walkers < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)cols | (uintptr_t)loads | (uintptr_t)lens) & 15)
    return (int)cudaErrorMisalignedAddress;
  StepWeights sw;
  for (int i = 0; i < MAX_STEPS; ++i) sw.w[i] = i <= l_max ? step_weights[i] : 0.0f;
  const long long walks = m_rows * n_walkers;
  if (walks == 0) return (int)cudaSuccess;
  const long long valid = (n_valid < m_rows ? n_valid : m_rows) * n_walkers;
  const int steps = l_max + 1;
  const int nt = walk_sample_threads(steps);
  const long long blocks = (walks + nt - 1) / nt;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)nt * steps * 8;
  cudaStream_t st = (cudaStream_t)stream;
  if (walks * steps < 0x7FFFFFFFLL) {
    walk_sample_kernel<unsigned int, Vals><<<(unsigned int)blocks, nt, smem, st>>>(
        (const int*)nbr, (const float*)wgt, (const int*)deg, (const int*)nodes,
        (int*)cols, (float*)loads, (int*)lens, (unsigned int)walks, max_deg,
        n_walkers, steps, seed, scheme, reweight, inv_c, p_halt, inv_n, sw,
        (const float*)f, (unsigned int)valid);
  } else {
    walk_sample_kernel<unsigned long long, Vals><<<(unsigned int)blocks, nt, smem, st>>>(
        (const int*)nbr, (const float*)wgt, (const int*)deg, (const int*)nodes,
        (int*)cols, (float*)loads, (int*)lens, (unsigned long long)walks,
        max_deg, n_walkers, steps, seed, scheme, reweight, inv_c, p_halt,
        inv_n, sw, (const float*)f, (unsigned long long)valid);
  }
  return (int)cudaGetLastError();
}

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// cols, loads, lens: 16-byte aligned [m_rows, n_walkers·(l_max+1)].
int walk_sample_launch(const void* nbr, const void* wgt, const void* deg,
                       const void* nodes, void* cols, void* loads, void* lens,
                       long long m_rows, int max_deg, int n_walkers, int l_max,
                       unsigned int seed, int scheme, int reweight, float inv_c,
                       float p_halt, float inv_n, const float* step_weights,
                       void* stream) {
  return launch<false>(nbr, wgt, deg, nodes, nullptr, cols, loads, lens, m_rows,
                       m_rows, max_deg, n_walkers, l_max, seed, scheme, reweight,
                       inv_c, p_halt, inv_n, step_weights, stream);
}

// cols, vals: 16-byte aligned [m_rows, n_walkers·(l_max+1)]; f: the l_max+1
// float32 modulation values on the device; vals is 0 on rows ≥ n_valid.
int walk_sample_vals_launch(const void* nbr, const void* wgt, const void* deg,
                            const void* nodes, const void* f, void* cols,
                            void* vals, long long m_rows, long long n_valid,
                            int max_deg, int n_walkers, int l_max,
                            unsigned int seed, int scheme, int reweight,
                            float inv_c, float p_halt, float inv_n,
                            const float* step_weights, void* stream) {
  return launch<true>(nbr, wgt, deg, nodes, f, cols, vals, nullptr, m_rows,
                      n_valid, max_deg, n_walkers, l_max, seed, scheme,
                      reweight, inv_c, p_halt, inv_n, step_weights, stream);
}

}  // extern "C"
