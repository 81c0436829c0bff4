"""Plain PyTorch versions of the sparse×sparse cross-Gram block.

Port of ``repro/kernels/gram_block/ref.py``.  ``gram_block_ref`` computes
G = Φ_rows Φ_colsᵀ ∈ R^{M_r × M_c} between two ELL row sets without any
N-long intermediate:

    G[i, j] = Σ_k Σ_l vals_rows[i,k] · vals_cols[j,l]
                        · [cols_rows[i,k] == cols_cols[j,l]],

so every matching pair counts and duplicate deposit columns are exact.  A
padding slot has value 0 (and column 0) and contributes exactly 0.

The JAX reference maps over query rows one at a time; here the rows go in
chunks sized so that the [rows, M_c, K_c, K_r] compare block stays under
``_BLOCK_BYTES`` (at M_c = 512, K = 144 one row's block is 42 MB).
"""
from __future__ import annotations

import torch

_BLOCK_BYTES = 256 * 2**20


def _row_chunk(m_c: int, k_c: int, k_r: int) -> int:
    return max(1, _BLOCK_BYTES // max(1, 4 * m_c * k_c * k_r))


def _match(cols_cols, cols_rows, dtype):
    """[rows, M_c, K_c, K_r] indicator cols_cols[j,l] == cols_rows[i,k]."""
    return (cols_cols[None, :, :, None] == cols_rows[:, None, None, :]).to(dtype)


def gram_block_ref(vals_rows: torch.Tensor, cols_rows: torch.Tensor,
                   vals_cols: torch.Tensor, cols_cols: torch.Tensor) -> torch.Tensor:
    """G = Φ_rows Φ_colsᵀ: vals_rows f32[M_r, K_r], cols_rows i32[M_r, K_r],
    vals_cols f32[M_c, K_c], cols_cols i32[M_c, K_c] → f32[M_r, M_c]."""
    vals_rows = vals_rows.to(torch.float32)
    vals_cols = vals_cols.to(torch.float32)
    m_r, k_r = vals_rows.shape
    m_c, k_c = vals_cols.shape
    step = _row_chunk(m_c, k_c, k_r)
    out = [
        torch.einsum("cl,rclk,rk->rc", vals_cols,
                     _match(cols_cols, cols_rows[i:i + step], vals_cols.dtype),
                     vals_rows[i:i + step])
        for i in range(0, m_r, step)
    ]
    if not out:
        return vals_rows.new_zeros((0, m_c))
    return torch.cat(out)


def gram_lookup_ref(g_rows: torch.Tensor, vals_cols: torch.Tensor,
                    cols_cols: torch.Tensor, cols_rows: torch.Tensor) -> torch.Tensor:
    """t[i,k] = Σ_j g_rows[i,j] · Φ_cols[j, cols_rows[i,k]] — the cotangent
    of :func:`gram_block_ref` with respect to the row values.

    g_rows f32[M_r, M_c]; vals_cols/cols_cols the payload looked up
    ([M_c, K_c]); cols_rows i32[M_r, K_r] → f32[M_r, K_r]."""
    vals_cols = vals_cols.to(torch.float32)
    g_rows = g_rows.to(torch.float32)
    m_r, k_r = cols_rows.shape
    m_c, k_c = vals_cols.shape
    step = _row_chunk(m_c, k_c, k_r)
    out = [
        torch.einsum("rc,cl,rclk->rk", g_rows[i:i + step], vals_cols,
                     _match(cols_cols, cols_rows[i:i + step], vals_cols.dtype))
        for i in range(0, m_r, step)
    ]
    if not out:
        return vals_cols.new_zeros((0, k_r))
    return torch.cat(out)
