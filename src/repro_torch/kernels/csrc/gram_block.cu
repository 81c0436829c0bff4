// Sparse×sparse cross-Gram block G = Φ_rows Φ_colsᵀ for sm_90a:
//   G[i, j] = Σ_k Σ_l vals_r[i,k]·vals_c[j,l]·[cols_r[i,k] == cols_c[j,l]].
//
// Replaces the TPU kernel src/repro/kernels/gram_block/gram_block.py:59
// `gram_block` (pallas_call at :80, body `_gram_kernel` :39).  Plain
// version: repro_torch/kernels/gram_block/ref.py `gram_block_ref`.
//
// What bounds it on this card: bytes.  G needs one multiply-add per pair of
// non-zero slots on the same column, Σ_col nnz_r(col)·nnz_c(col), few on
// graph-local walks, against (M_r·K_r + M_c·K_c)·8 + M_r·M_c·4 bytes moved.
// Nothing is N-long.  This kernel's design does far more work than that: it
// compares every (query slot, train slot) pair, M_r·M_c·K_r·K_c in all
// (5.4·10⁹ for the 512×512 Thompson Gram at K = 144), so it runs far from
// the bound; a per-row hash or sorted merge of the columns would not.
//
// Design.  The TPU kernel pinned the whole train payload in VMEM with a
// (0, 0) index map and padded the query rows to its block.  Here a block
// owns a TILE × TILE tile of G (query rows × train rows), one thread per
// (i, j), no atomics, so the result is deterministic.  The block stages
// the query tile's slots in shared memory, KR_CHUNK slots at a time, laid
// out slot-major so that the two query rows a warp touches are read as
// broadcasts from two banks.  Each thread holds KC_REG of its train row's
// slots in registers and, for every staged query slot, compares it against
// all of them (unrolled), so one shared-memory load feeds KC_REG compares.
// Neither operand is assumed to fit in shared memory: both K loops are
// chunked, and ragged M_r, M_c, K_r, K_c are handled by bounds checks (an
// out-of-range query slot gets column −1 and an out-of-range train slot
// column −2, so they never match), never by padding copies.  The sum
// order differs from the plain einsum; parity is to 1e-5 of scale.
#include <cuda_runtime.h>

#define TILE 16
#define KR_CHUNK 128
#define KC_REG 16

__global__ void gram_block_kernel(const float* __restrict__ vals_r,
                                  const int* __restrict__ cols_r,
                                  const float* __restrict__ vals_c,
                                  const int* __restrict__ cols_c,
                                  float* __restrict__ out, long long m_r,
                                  int k_r, long long m_c, int k_c) {
  __shared__ int s_col[KR_CHUNK][TILE];
  __shared__ float s_val[KR_CHUNK][TILE];
  const int tx = threadIdx.x;  // train row within the tile
  const int ty = threadIdx.y;  // query row within the tile
  const int tid = ty * TILE + tx;
  const long long i0 = (long long)blockIdx.x * TILE;
  const long long j = (long long)blockIdx.y * TILE + tx;
  const bool j_ok = j < m_c;
  const float* vrow_c = vals_c + (j_ok ? j : 0) * k_c;
  const int* crow_c = cols_c + (j_ok ? j : 0) * k_c;

  float acc = 0.0f;
  for (int k0 = 0; k0 < k_r; k0 += KR_CHUNK) {
    const int kn = min(KR_CHUNK, k_r - k0);
    __syncthreads();  // the previous chunk is no longer read
    // Row-major reads from global (consecutive threads, consecutive slots),
    // slot-major writes to shared memory.
    for (int t = tid; t < TILE * kn; t += TILE * TILE) {
      const int rr = t / kn;
      const int kk = t - rr * kn;
      const long long gi = i0 + rr;
      int c = -1;
      float v = 0.0f;
      if (gi < m_r) {
        c = cols_r[gi * k_r + k0 + kk];
        v = vals_r[gi * k_r + k0 + kk];
      }
      s_col[kk][rr] = c;
      s_val[kk][rr] = v;
    }
    __syncthreads();
    for (int l0 = 0; l0 < k_c; l0 += KC_REG) {
      int cl[KC_REG];
      float vl[KC_REG];
#pragma unroll
      for (int u = 0; u < KC_REG; ++u) {
        const bool in = j_ok && (l0 + u) < k_c;
        cl[u] = in ? crow_c[l0 + u] : -2;
        vl[u] = in ? vrow_c[l0 + u] : 0.0f;
      }
      for (int k = 0; k < kn; ++k) {
        const int c = s_col[k][ty];
        float part = 0.0f;
#pragma unroll
        for (int u = 0; u < KC_REG; ++u) part += (cl[u] == c) ? vl[u] : 0.0f;
        acc += s_val[k][ty] * part;
      }
    }
  }
  const long long i = i0 + ty;
  if (i < m_r && j_ok) out[i * m_c + j] = acc;
}

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int gram_block_launch(const void* vals_r, const void* cols_r,
                      const void* vals_c, const void* cols_c, void* out,
                      long long m_r, int k_r, long long m_c, int k_c,
                      void* stream) {
  if (m_r == 0 || m_c == 0) return (int)cudaSuccess;
  const long long gx = (m_r + TILE - 1) / TILE;
  const long long gy = (m_c + TILE - 1) / TILE;
  if (gx > 2147483647LL || gy > 65535LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)gx, (unsigned int)gy);
  dim3 block(TILE, TILE);
  gram_block_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)vals_r, (const int*)cols_r, (const float*)vals_c,
      (const int*)cols_c, (float*)out, m_r, k_r, m_c, k_c);
  return (int)cudaGetLastError();
}

}  // extern "C"
