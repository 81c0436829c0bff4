"""Plain PyTorch versions of the ELL sparse-product kernels.

Port of ``repro/kernels/ell_spmv/ref.py``.  The CPU path of the port runs
these; the CUDA kernels in ``csrc/`` are held against them on the card.
bf16 payloads are upcast to float32 before any arithmetic (exact), as the
JAX reference's dtype promotion does.
"""
from __future__ import annotations

import torch


def ell_spmv_ref(vals: torch.Tensor, cols: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """y[m] = Σ_k vals[m,k] · u[cols[m,k]].

    vals: [M, K]; cols: i32[M, K]; u: f32[N] or [N, R] → f32[M] or [M, R]."""
    vals = vals.to(torch.float32)
    gathered = u[cols.long()]  # [M, K] or [M, K, R]
    if u.dim() == 1:
        return torch.einsum("mk,mk->m", vals, gathered)
    return torch.einsum("mk,mkr->mr", vals, gathered)


def ell_spmv_t_ref(vals: torch.Tensor, cols: torch.Tensor, v: torch.Tensor,
                   n_nodes: int) -> torch.Tensor:
    """u[j] = Σ_{m,k : cols[m,k]=j} vals[m,k] · v[m]  (u = Φᵀ v).

    vals: [M, K]; cols: i32[M, K]; v: f32[M] or [M, R] → f32[N] or [N, R]."""
    vals = vals.to(torch.float32)
    flat_cols = cols.reshape(-1).long()
    if v.dim() == 1:
        contrib = (vals * v[:, None]).reshape(-1)
        out = torch.zeros((n_nodes,), dtype=contrib.dtype, device=v.device)
    else:
        contrib = (vals[..., None] * v[:, None, :]).reshape(-1, v.shape[-1])
        out = torch.zeros((n_nodes, v.shape[-1]), dtype=contrib.dtype,
                          device=v.device)
    return out.index_add_(0, flat_cols, contrib)


def khat_matvec_ref(vals_rows, cols_rows, vals_cols, cols_cols, v,
                    n_nodes: int) -> torch.Tensor:
    """y = Φ_rows (Φ_colsᵀ v) — the (cross-)K̂ matvec, unfused."""
    return ell_spmv_ref(
        vals_rows, cols_rows, ell_spmv_t_ref(vals_cols, cols_cols, v, n_nodes)
    )


def khat_matvec_indexed_ref(vals_rows, cols_rows, vals_cols, index, v):
    """y = Φ_rows (Φ_colsᵀ v) by the fused kernel's algorithm, in plain
    PyTorch: u = Φ_colsᵀ v summed by the index's column segments into a
    compact [U(, R)], then Φ_rows gathered through the node → compact-id
    map, where a slot whose column no non-zero slot of Φ_cols touched adds
    nothing.  ``index`` is ``column_index(cols_cols, vals_cols, N)`` (see
    index.py).  The CUDA kernel computes this on the card; this version is
    what the CPU tests hold the index against."""
    vals_cols = vals_cols.to(torch.float32)
    vals_rows = vals_rows.to(torch.float32)
    k_c = vals_cols.shape[1]
    order = index.order.long()
    counts = index.seg[1:] - index.seg[:-1]
    seg_id = torch.repeat_interleave(
        torch.arange(index.n_uniq, device=v.device), counts.long())
    w = vals_cols.reshape(-1)[order]
    src = v[order // max(k_c, 1)]
    contrib = w * src if v.dim() == 1 else w[:, None] * src
    # One zero row past the U compact ones stands for every column outside
    # the index.
    u = v.new_zeros((index.n_uniq + 1,) + tuple(v.shape[1:]))
    u.index_add_(0, seg_id, contrib)
    ids = index.node_map[cols_rows.long()].long()          # [M_r, K_r]
    gathered = u[torch.where(ids >= 0, ids, index.n_uniq)]
    if v.dim() == 1:
        return torch.einsum("mk,mk->m", vals_rows, gathered)
    return torch.einsum("mk,mkr->mr", vals_rows, gathered)
