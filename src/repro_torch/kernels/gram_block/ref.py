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


def _kernel_order_sums(same: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sums[r, a] = Σ_b same[r, a, b]·v[r, b] in the CUDA kernel's order:
    each chunk of 32 slots in slot order (all chunks at once), then the
    chunks' sums in order.  Bit-equality with the kernel rests on copying
    that order, not on the sum itself: each product is exact (``same`` is 0
    or 1), adding a zero leaves a sum as it is, and any other order gives
    another float32 rounding (``tests/test_torch_gram.py`` holds these sums
    to an order-free one within float32 tolerance)."""
    r, k = v.shape
    chunks = -(-k // 32)
    pad = chunks * 32 - k
    s = torch.nn.functional.pad(same.to(v.dtype), (0, pad)).reshape(r, k, chunks, 32)
    w = torch.nn.functional.pad(v, (0, pad)).reshape(r, 1, chunks, 32)
    part = torch.zeros((r, k, chunks), dtype=v.dtype, device=v.device)
    for b in range(32):
        part = part + s[..., b] * w[..., b]
    total = torch.zeros_like(v)
    for c in range(chunks):
        total = total + part[..., c]
    return total


def aggregate_rows_ref(vals: torch.Tensor, cols: torch.Tensor):
    """Each row's distinct (column, Σ value) entries over its non-zero slots,
    in order of first occurrence — the CUDA kernel's first step, in plain
    PyTorch, summed in the kernel's order (:func:`_kernel_order_sums`), so
    that the kernel is held to it bit for bit.  vals f32[M, K], cols i32[M, K]
    → (cols i32[M, K], sums f32[M, K], counts i32[M]); entries past a row's
    count are column −1 and value 0.  Since G[i, j] = Σ_c A_i(c)·B_j(c) for
    the aggregated rows A and B, ``gram_block_ref`` of the two aggregated
    payloads is G."""
    vals = vals.to(torch.float32)
    m, k = vals.shape
    out_c = torch.full((m, k), -1, dtype=torch.int32, device=vals.device)
    out_v = torch.zeros((m, k), dtype=torch.float32, device=vals.device)
    counts = torch.zeros((m,), dtype=torch.int32, device=vals.device)
    step = max(1, _BLOCK_BYTES // max(1, 4 * k * k))
    slot = torch.arange(k, device=vals.device)
    for i in range(0, m if k else 0, step):
        v, c = vals[i:i + step], cols[i:i + step]
        live = v != 0
        # same[r, a, b]: slots a and b of row r are live and share a column.
        same = (c[:, :, None] == c[:, None, :]) & live[:, :, None] & live[:, None, :]
        first = live & (same.to(torch.int8).argmax(dim=2) == slot)
        sums = _kernel_order_sums(same, v)
        at = torch.cumsum(first.to(torch.int64), dim=1) - 1
        rows = torch.arange(v.shape[0], device=vals.device)[:, None].expand_as(at)
        out_c[i:i + step][rows[first], at[first]] = c[first].to(torch.int32)
        out_v[i:i + step][rows[first], at[first]] = sums[first]
        counts[i:i + step] = first.sum(dim=1).to(torch.int32)
    return out_c, out_v, counts
