"""Stochastic Lanczos quadrature: log-det and LML *values* from CG (port of
``repro/solvers/slq.py``).

The CG recurrence scalars (α_j, β_j) of a fixed-iteration solve are the
Lanczos tridiagonalisation of H in disguise (Saad §6.7), so for Rademacher
probes z with E[zzᵀ] = I,

    log det H = tr(log H) = E_z[zᵀ (log H) z]
              ≈ (1/S) Σ_i ‖z_i‖² Σ_k τ_{ik}² log θ_{ik},

where (θ, τ) are the eigenvalues and first-row eigenvector weights of probe
i's m×m tridiagonal T_i.  Per probe this costs one m-iteration CG pass (the
matvecs dominate) plus an O(m³) eigensolve of T; the batched [S, m, m]
``torch.linalg.eigh`` is plain PyTorch, as the JAX package leaves its
``jnp.linalg.eigh`` outside any Pallas kernel.

The pass runs **unpreconditioned**: preconditioned CG coefficients
tridiagonalise M^{-1/2} H M^{-1/2}, whose quadrature would need
M-distributed probes to be unbiased for H.  With the identity
preconditioner the estimate is unbiased as it is.
"""
from __future__ import annotations

from typing import Callable

import torch

from .cg import LanczosCoeffs, cg_solve_fixed


def rademacher(generator: torch.Generator, shape,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """±1 Hutchinson probes (E[zzᵀ] = I, ‖z‖² exact), drawn from
    ``generator`` on its own device and moved to ``device`` (default: the
    generator's)."""
    gdev = generator.device
    bits = torch.randint(0, 2, tuple(shape), generator=generator, device=gdev)
    z = bits.to(dtype) * 2.0 - 1.0
    return z if device is None else z.to(device)


def tridiag_from_coeffs(coeffs: LanczosCoeffs) -> torch.Tensor:
    """[R, m, m] symmetric tridiagonals from per-column CG scalars.

    Iterations after breakdown or convergence (``valid`` False) become
    decoupled unit diagonal entries: e₁ has zero weight on their
    eigenvectors, so they contribute nothing to the quadrature."""
    alphas, betas, valid = coeffs.alphas, coeffs.betas, coeffs.valid
    m = alphas.shape[0]
    one = torch.ones_like(alphas)
    a_safe = torch.where(valid, torch.clamp(alphas, min=1e-30), one)
    ratio = torch.where(valid, betas / a_safe, torch.zeros_like(alphas))
    prev = torch.cat([torch.zeros_like(ratio[:1]), ratio[:-1]], dim=0)
    diag = torch.where(valid, 1.0 / a_safe + prev, one)            # [m, R]
    # off[j] couples j, j+1 — live only when both iterations executed.
    both = valid[:-1] & valid[1:]
    off = torch.where(both, torch.sqrt(torch.clamp(betas[:-1], min=0.0))
                      / a_safe[:-1], torch.zeros_like(betas[:-1]))  # [m-1, R]
    return (torch.diag_embed(diag.T) + torch.diag_embed(off.T, offset=1)
            + torch.diag_embed(off.T, offset=-1))


def logdet_from_coeffs(coeffs: LanczosCoeffs) -> torch.Tensor:
    """Average the per-probe Gauss quadratures into the log-det estimate."""
    theta, vecs = torch.linalg.eigh(tridiag_from_coeffs(coeffs))  # [R, m, m]
    tau2 = vecs[:, 0, :] ** 2                                      # e₁ weights
    quad = torch.sum(tau2 * torch.log(torch.clamp(theta, min=1e-12)), dim=1)
    return torch.mean(coeffs.bnorm2 * quad)


def slq_logdet(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    dim: int,
    generator: torch.Generator,
    n_probes: int = 32,
    n_iters: int = 64,
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    device=None,
) -> torch.Tensor:
    """log det H for SPD H given only a matvec (Hutchinson × Lanczos).

    ``n_iters`` caps the Krylov depth (clamped to ``dim``); Rademacher
    probes give ‖z‖² = dim exactly.  The probes come from ``generator`` and
    are moved to ``device`` (the operator's; default: the generator's).
    Error is O(1/√S) in probes plus the quadrature tail, exponentially small
    in m."""
    z = rademacher(generator, (dim, n_probes), device=device)
    _, coeffs = cg_solve_fixed(matvec, z, iters=min(n_iters, dim), dot=dot,
                               with_coeffs=True)
    return logdet_from_coeffs(coeffs)
