// Fused Nyström–Woodbury preconditioner apply for sm_90a:
//   out = M⁻¹v = D⁻¹(v − B s),   s = E⁻¹ Bᵀ(D⁻¹v),
// with B f32[T, r], D⁻¹ f32[T], E⁻¹ f32[r, r] and v, out f32[T, R].
//
// Replaces the TPU kernel src/repro/kernels/woodbury_apply/woodbury_apply.py:75
// `woodbury_apply` (pallas_call at :100, body `_woodbury_kernel` :41).  Plain
// version: repro_torch/kernels/woodbury_apply/ref.py `woodbury_apply_ref`.
//
// What bounds it on this card: bytes.  The function reads B, D⁻¹, E⁻¹ and v
// once and writes out once, (T·r + T + r² + 2·T·R)·4 bytes (0.65 µs at
// T = 4000, r = 128, R = 1 at 3.35 TB/s), against 4·T·r·R + 2·r²·R float32
// operations (≈0.03 µs at 67 TFLOP/s).  At the CG shapes it is launch-bound:
// the work is a few microseconds of latency, not of bandwidth.
//
// Design.  The TPU kernel ran a sequential (phase, block) grid with the
// rank-space sum s in VMEM scratch and E⁻¹ pinned in VMEM.  Here ONE
// cooperative launch (cudaLaunchCooperativeKernel, the grid sized to the
// blocks that can be resident at once) runs four phases separated by
// cooperative_groups grid.sync():
//   1 reduce   each 32-row tile of B is staged in shared memory (rows padded
//              to r + 1 floats, so a warp reading one column across rows hits
//              distinct banks) with the tile of D⁻¹v beside it; the block
//              writes that tile's [r, R] partial of Bᵀ(D⁻¹v) to a global
//              scratch slot of its own;
//   2 sum      u = Σ_tiles partials, one thread per (j, c), in tile order;
//   3 capacity s = E⁻¹u, one warp per (j, c): the lanes stride over k, so a
//              row of E⁻¹ is read coalesced, and a fixed shuffle tree sums
//              them.  E⁻¹ is streamed from global memory and L2, never copied
//              on chip: at r = 256 it is 256 KB, more than the 227 KB of
//              shared memory a block can have;
//   4 expand   each tile of B is staged again (B was read a moment ago and is
//              still in the 50 MB L2: 4.1 MB at T = 4000, r = 256) and
//              out = D⁻¹(v − B s) is written, one thread per (row, c).
// No float atomics: every sum has a fixed order that does not depend on the
// grid size, so the apply is deterministic, run after run and card after
// card.  Ragged T is handled by bounds checks (rows past T stage zeros and
// write nothing), never by padding copies.  r is runtime (1..8447: the tile
// shrinks below 32 rows past r = 263) and R is runtime (1..64; the wrapper
// splits wider v).  D⁻¹ entries of 1.0 and 1e-6 are plain multipliers.
// Float32 FMA only; no tensor cores, no TMA.  Results differ from the plain
// version's in summation order only: parity is to 1e-5 of scale.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define THREADS 256
#define MAX_TILE_ROWS 32
#define B_TILE_FLOATS 8448  // 32 rows × 264
#define W_TILE_FLOATS 2048  // 32 rows × 64 columns
#define MAX_COLS 64         // the wrapper splits a wider v into launches

// Rows of B per tile: 32 while a padded row (r + 1 floats) fits 32 times.
static int tile_rows(int r) {
  const int rows = B_TILE_FLOATS / (r + 1);
  return rows < MAX_TILE_ROWS ? rows : MAX_TILE_ROWS;
}

__device__ __forceinline__ void stage_b(const float* __restrict__ b,
                                        float* bs, long long row0, int rows,
                                        long long t, int r) {
  const int ld = r + 1;
  for (int q = threadIdx.x; q < rows * r; q += THREADS) {
    const int i = q / r;
    const int j = q - i * r;
    const long long row = row0 + i;
    bs[i * ld + j] = row < t ? b[row * r + j] : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
    woodbury_kernel(const float* __restrict__ b, const float* __restrict__ dinv,
                    const float* __restrict__ einv, const float* __restrict__ v,
                    float* __restrict__ out, float* __restrict__ part,
                    long long t, int r, int ncols, int rows, long long tiles) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float bs[B_TILE_FLOATS];
  __shared__ float ws[W_TILE_FLOATS];
  const int tid = threadIdx.x;
  const int ld = r + 1;
  const int rr = r * ncols;
  float* u = part + tiles * rr;
  float* s = u + rr;

  // Phase 1: the [r, R] partial of Bᵀ(D⁻¹v) of each row tile.
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * rows;
    __syncthreads();  // the previous tile is no longer read
    stage_b(b, bs, row0, rows, t, r);
    for (int q = tid; q < rows * ncols; q += THREADS) {
      const int i = q / ncols;
      const long long row = row0 + i;
      ws[q] = row < t ? dinv[row] * v[row * ncols + (q - i * ncols)] : 0.0f;
    }
    __syncthreads();
    float* dst = part + tile * rr;
    for (int q = tid; q < rr; q += THREADS) {
      const int j = q / ncols;
      const int c = q - j * ncols;
      float acc = 0.0f;
      for (int i = 0; i < rows; ++i) acc += bs[i * ld + j] * ws[i * ncols + c];
      dst[q] = acc;
    }
  }
  grid.sync();

  // Phase 2: u = Σ over tiles, in tile order.
  const long long gtid = (long long)blockIdx.x * THREADS + tid;
  const long long gstride = (long long)gridDim.x * THREADS;
  for (long long q = gtid; q < rr; q += gstride) {
    float acc = 0.0f;
    for (long long k = 0; k < tiles; ++k) acc += part[k * rr + q];
    u[q] = acc;
  }
  grid.sync();

  // Phase 3: s = E⁻¹u, one warp per entry (q is the same for all 32 lanes).
  const int lane = tid & 31;
  for (long long q = gtid >> 5; q < rr; q += gstride >> 5) {
    const int j = (int)(q / ncols);
    const int c = (int)(q - (long long)j * ncols);
    const float* erow = einv + (long long)j * r;
    float acc = 0.0f;
    for (int k = lane; k < r; k += 32) acc += erow[k] * u[k * ncols + c];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) s[q] = acc;
  }
  grid.sync();

  // Phase 4: out = D⁻¹(v − B s).
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * rows;
    __syncthreads();
    stage_b(b, bs, row0, rows, t, r);
    __syncthreads();
    for (int q = tid; q < rows * ncols; q += THREADS) {
      const int i = q / ncols;
      const int c = q - i * ncols;
      const long long row = row0 + i;
      if (row >= t) continue;
      float acc = 0.0f;
      for (int j = 0; j < r; ++j) acc += bs[i * ld + j] * s[j * ncols + c];
      out[row * ncols + c] = dinv[row] * (v[row * ncols + c] - acc);
    }
  }
}

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Floats of scratch a launch needs: an [r, ncols] partial per row tile,
// then u and s; −1 if the kernel does not take this r or ncols.
long long woodbury_apply_scratch_floats(long long t, int r, int ncols) {
  if (r < 1 || r + 1 > B_TILE_FLOATS || ncols < 1 || ncols > MAX_COLS)
    return -1;
  const int rows = tile_rows(r);
  return ((t + rows - 1) / rows + 2) * (long long)r * ncols;
}

// part: woodbury_apply_scratch_floats(t, r, ncols) floats of scratch.
int woodbury_apply_launch(const void* b, const void* dinv, const void* einv,
                          const void* v, void* out, void* part, long long t,
                          int r, int ncols, void* stream) {
  if (t == 0) return (int)cudaSuccess;
  if (woodbury_apply_scratch_floats(t, r, ncols) < 0)
    return (int)cudaErrorInvalidValue;
  int rows = tile_rows(r);
  long long tiles = (t + rows - 1) / rows;

  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, woodbury_kernel,
                                                      THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  // Enough blocks for a tile each, or for a warp per entry of s.
  const long long rr = (long long)r * ncols;
  long long blocks = tiles;
  const long long warp_blocks = (rr * 32 + THREADS - 1) / THREADS;
  if (warp_blocks > blocks) blocks = warp_blocks;
  const long long resident = (long long)per_sm * sms;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;

  const float* a0 = (const float*)b;
  const float* a1 = (const float*)dinv;
  const float* a2 = (const float*)einv;
  const float* a3 = (const float*)v;
  float* a4 = (float*)out;
  float* a5 = (float*)part;
  void* args[] = {(void*)&a0, (void*)&a1, (void*)&a2,    (void*)&a3,
                  (void*)&a4, (void*)&a5, (void*)&t,     (void*)&r,
                  (void*)&ncols, (void*)&rows, (void*)&tiles};
  err = cudaLaunchCooperativeKernel((const void*)woodbury_kernel,
                                    dim3((unsigned int)blocks), dim3(THREADS),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
