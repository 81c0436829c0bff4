// GRF walk sampling (paper Alg. 1/2) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/walk_sampler/walk_sampler.py:59
// `walk_sample` (pallas_call at :92, body `_walk_kernel` :39 running
// ref.walk_block, ref.py:36).  Plain version: repro_torch/kernels/
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
// Design: one thread per (start node, walker), the l_max+1 steps in
// registers.  Threads are numbered walker-fastest, so the triples a warp
// writes at one step lie in one contiguous run of 32·(l_max+1) slots.
// The uint32 counter hash is native here; it is the hash of rng.py.
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

__device__ __forceinline__ uint32_t counter_bits(uint32_t seed, uint32_t node,
                                                 uint32_t walker, uint32_t ctr) {
  uint32_t h = seed ^ 0x9E3779B9u;
  h = fmix32(h ^ (node * 0x85EBCA6Bu));
  h = fmix32(h ^ (walker * 0xC2B2AE35u));
  h = fmix32(h ^ (ctr * 0x27D4EB2Fu));
  return h;
}

__device__ __forceinline__ float to_uniform(uint32_t bits) {
  // Top 24 bits, exact in float32, times 2^-24.
  return __uint2float_rn(bits >> 8) * 5.9604644775390625e-08f;
}

enum Scheme { IID = 0, ANTITHETIC = 1, QMC = 2, GRFSPP = 3 };

__device__ __forceinline__ float halt_uniform(int scheme, uint32_t seed,
                                              uint32_t node, uint32_t walker,
                                              uint32_t ctr) {
  if (scheme == ANTITHETIC) {
    float u = to_uniform(counter_bits(seed, node, walker & 0xFFFFFFFEu, ctr));
    return (walker & 1u) ? 1.0f - u : u;
  }
  if (scheme == QMC) {
    uint32_t shift = counter_bits(seed, node, 0xFFFFFFFFu, ctr);
    return to_uniform(__brev(walker) ^ shift);
  }
  return to_uniform(counter_bits(seed, node, walker, ctr));
}

__global__ void walk_sample_kernel(
    const int* __restrict__ nbr, const float* __restrict__ wgt,
    const int* __restrict__ deg, const int* __restrict__ nodes,
    int* __restrict__ cols, float* __restrict__ loads, int* __restrict__ lens,
    long long m_rows, int max_deg, int n_walkers, int l_max, uint32_t seed,
    int scheme, int reweight, float inv_c, float p_halt, float inv_n,
    StepWeights sw) {
  long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= m_rows * n_walkers) return;
  const long long m = tid / n_walkers;
  const uint32_t walker = (uint32_t)(tid - m * n_walkers);
  const int steps = l_max + 1;
  // Slot of (m, walker, 0) is m·K + walker·steps = tid·steps.
  const long long base = tid * steps;
  const int start = nodes[m];
  const uint32_t node_u = (uint32_t)start;

  int cur = start;
  float load = 1.0f, alive = 1.0f;
  for (int step = 0; step < steps; ++step) {
    cols[base + step] = cur;
    lens[base + step] = step;
    float dep = load * alive;
    if (scheme == GRFSPP) dep = dep * sw.w[step];
    loads[base + step] = dep * inv_n;

    const float u = to_uniform(counter_bits(seed, node_u, walker, 2u * step));
    const int d = deg[cur];
    // Degree 0: choice 0 lands on the zero padding, as in ref.py.
    const int choice = min((int)(u * (float)d), max(d - 1, 0));
    const long long flat = (long long)cur * max_deg + choice;
    const int nxt = nbr[flat];
    const float w = wgt[flat];
    load = reweight ? ((load * (float)d) * inv_c) * w : load * w;
    if (scheme != GRFSPP) {
      const float uh = halt_uniform(scheme, seed, node_u, walker, 2u * step + 1u);
      alive = alive * (uh >= p_halt ? 1.0f : 0.0f);
    }
    alive = alive * (d > 0 ? 1.0f : 0.0f);
    cur = nxt;
  }
}

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int walk_sample_launch(const void* nbr, const void* wgt, const void* deg,
                       const void* nodes, void* cols, void* loads, void* lens,
                       long long m_rows, int max_deg, int n_walkers, int l_max,
                       unsigned int seed, int scheme, int reweight, float inv_c,
                       float p_halt, float inv_n, const float* step_weights,
                       void* stream) {
  if (l_max + 1 > MAX_STEPS) return (int)cudaErrorInvalidValue;
  StepWeights sw;
  for (int i = 0; i < MAX_STEPS; ++i) sw.w[i] = i <= l_max ? step_weights[i] : 0.0f;
  const long long total = m_rows * n_walkers;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  walk_sample_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)nbr, (const float*)wgt, (const int*)deg, (const int*)nodes,
      (int*)cols, (float*)loads, (int*)lens, m_rows, max_deg, n_walkers, l_max,
      seed, scheme, reweight, inv_c, p_halt, inv_n, sw);
  return (int)cudaGetLastError();
}

}  // extern "C"
