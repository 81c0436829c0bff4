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
