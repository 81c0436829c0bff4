"""Johnson–Lindenstrauss + Woodbury linear solver (port of
``repro/core/jlt.py``; paper App. B).

Approximates K̂ = ΦΦᵀ by K₁K₁ᵀ with K₁ = ΦG/√m (G Gaussian, m ≪ N), then
solves (K̂+σ²I)v = b via the m×m Woodbury system — O(N·K·m + m³) here since
ΦG uses the sparse trace (the ``ell_spmv`` kernel at R = m) rather than a
dense Φ.
"""
from __future__ import annotations

import math

import torch

from ..gp.exact import cholesky_or_nan
from . import features
from .walks import WalkTrace


def jlt_features(
    trace: WalkTrace, f: torch.Tensor, generator: torch.Generator, m: int,
    n_nodes: int,
) -> torch.Tensor:
    """K₁ = ΦG/√m ∈ R^{rows×m} via the sparse Φ-matvec against random G.

    G [n_nodes, m] is drawn from ``generator`` on its device, then moved to
    the trace's.  ``n_nodes`` is the Φ *column*-space size (the full graph
    N) — NOT the row count, which differs for training-subset traces."""
    g = torch.randn((n_nodes, m), generator=generator,
                    device=generator.device, dtype=torch.float32)
    g = g.to(trace.cols.device)
    return features.phi_matvec(trace, f, g) / math.sqrt(float(m))


def woodbury_solve(k1: torch.Tensor, sigma_n2, b: torch.Tensor) -> torch.Tensor:
    """Solve (K₁K₁ᵀ + σ²I) v = b via Eq. 14/15 (b: [T] or [T, R])."""
    s2 = torch.as_tensor(sigma_n2, dtype=k1.dtype, device=k1.device)
    u = k1 / torch.sqrt(s2)
    m = u.shape[1]
    inner = torch.eye(m, dtype=u.dtype, device=u.device) + u.T @ u
    chol = cholesky_or_nan(inner)
    b2 = b[:, None] if b.dim() == 1 else b
    w = torch.cholesky_solve(u.T @ b2, chol)
    out = (b2 - u @ w) / s2
    return out[:, 0] if b.dim() == 1 else out
