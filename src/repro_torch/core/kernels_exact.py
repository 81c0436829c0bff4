"""Exact dense graph-node kernels (port of ``repro/core/kernels_exact.py``;
the paper's baselines, O(N³)).

Computed by eigendecomposition of the normalised Laplacian L̃ = I − Ã, in
float32 on the graph's device (``torch.linalg.eigh``).  Only usable for
small N — that asymmetry is the paper's point.

Graphs with repeated Laplacian eigenvalues (grids) have eigenvectors that
are defined only up to a rotation inside each eigenspace, and two
eigensolvers pick different ones: compare eigenvalues, or kernels built
from them, never eigenvectors.
"""
from __future__ import annotations

import torch

from ..graphs.formats import Graph, normalized_laplacian, to_dense


def laplacian_eigh(graph: Graph) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of L̃ (spectrum in [0, 2])."""
    evals, evecs = torch.linalg.eigh(normalized_laplacian(graph))
    return evals, evecs


def diffusion_kernel(
    graph: Graph, beta: float, sigma_f: float = 1.0,
    eig: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """K_diff = σ_f · exp(−β L̃)."""
    evals, evecs = eig if eig is not None else laplacian_eigh(graph)
    return sigma_f * (evecs * torch.exp(-beta * evals)) @ evecs.T


def matern_kernel(
    graph: Graph, nu: float, kappa: float, sigma_f: float = 1.0,
    eig: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """K_Matérn ∝ σ_f · (2ν/κ² + L̃)^{−ν}, normalised to unit mean diagonal."""
    evals, evecs = eig if eig is not None else laplacian_eigh(graph)
    spec = (2.0 * nu / kappa**2 + evals) ** (-nu)
    k = (evecs * spec) @ evecs.T
    return sigma_f * k / torch.mean(torch.diagonal(k))


def truncated_power_series_kernel(graph: Graph, f: torch.Tensor) -> torch.Tensor:
    """Exact E[K̂] under walk truncation: K = Ψ_truncᵀ Ψ_trunc with
    Ψ_trunc = Σ_{l≤l_max} f_l Ã^l — the exact target of the GRF Monte-Carlo
    estimator."""
    a = to_dense(graph)
    n = graph.n_nodes
    psi = torch.zeros((n, n), dtype=a.dtype, device=a.device)
    power = torch.eye(n, dtype=a.dtype, device=a.device)
    f = f.to(device=a.device, dtype=a.dtype)
    for l in range(f.shape[0]):
        psi = psi + f[l] * power
        if l + 1 < f.shape[0]:
            power = power @ a
    return psi.T @ psi
