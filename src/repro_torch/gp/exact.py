"""Exact dense GP baseline (Cholesky, O(N³)) — port of ``repro/gp/exact.py``,
the paper's comparison point.

Also hosts the 'GRFs (Dense)' variant of Table 1: GRF features materialised
into an explicit N×N kernel (``features.materialize_khat``) and inverted
densely.

A non-positive-definite input gives a NaN factor, as ``jnp.linalg.cholesky``
does, where ``torch.linalg.cholesky`` would raise: :func:`cholesky_or_nan`
factorises with ``torch.linalg.cholesky_ex`` and fills the factor with NaN
when ``info`` is non-zero, on the device, without a host read.  So a
failed factorisation shows as NaN means, variances and losses, never as an
exception mid-fit.
"""
from __future__ import annotations

import math

import torch

from ..core.kernels_exact import laplacian_eigh
from ..graphs.formats import Graph
from ..optim.adamw import AdamW
from .mll import _value_and_grad


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``a`` ([..., n, n]); all NaN where ``a`` is
    not positive definite (no exception, no host read)."""
    chol, info = torch.linalg.cholesky_ex(a)
    ok = (info == 0)[..., None, None]
    return torch.where(ok, chol, torch.full_like(chol, float("nan")))


def _eye_like(t: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(t, dtype=like.dtype, device=like.device)


def cholesky_posterior(
    k_full: torch.Tensor,
    train_nodes: torch.Tensor,
    y: torch.Tensor,
    sigma_n2,
):
    """Exact Eq. 3/4 given a dense kernel over all nodes.

    Returns (mean[N], var[N])."""
    idx = torch.as_tensor(train_nodes, device=k_full.device).long()
    k_fx = k_full[:, idx]
    k_xx = k_fx[idx]
    t = idx.shape[0]
    chol = cholesky_or_nan(k_xx + sigma_n2 * _eye_like(t, k_xx))
    alpha = torch.cholesky_solve(y.to(k_full.dtype)[:, None], chol)[:, 0]
    mean = k_fx @ alpha
    v = torch.linalg.solve_triangular(chol, k_fx.T, upper=False)
    var = torch.diagonal(k_full) - torch.sum(v * v, dim=0)
    return mean, torch.clamp(var, min=0.0)


def exact_nlml(k_xx: torch.Tensor, y: torch.Tensor, sigma_n2) -> torch.Tensor:
    """Exact negative log marginal likelihood (Eq. 8) — test oracle."""
    t = y.shape[0]
    chol = cholesky_or_nan(k_xx + sigma_n2 * _eye_like(t, k_xx))
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    return 0.5 * torch.dot(y, alpha) + 0.5 * logdet + 0.5 * t * math.log(
        2 * math.pi)


def fit_exact_diffusion(
    graph: Graph, train_nodes, y: torch.Tensor, steps: int = 200,
    lr: float = 0.05, init_beta: float = 1.0, init_noise: float = 0.1,
):
    """Train (β, σ_f, σ_n) of the exact diffusion kernel by full-LML
    autograd, with the JAX package's parameter names (``log_beta``,
    ``log_sigma_f``, ``log_sigma_n``) and AdamW.

    Uses one eigendecomposition of L̃, then O(N²) per step.  Returns
    (params, k_full)."""
    evals, evecs = laplacian_eigh(graph)
    dev = evals.device
    idx = torch.as_tensor(train_nodes, device=dev).long()
    ex = evecs[idx]
    y = y.to(device=dev, dtype=torch.float32)

    def spectrum(params):
        return torch.exp(params["log_sigma_f"]) * torch.exp(
            -torch.exp(params["log_beta"]) * evals)

    def loss(params):
        k_xx = (ex * spectrum(params)) @ ex.T
        return exact_nlml(k_xx, y, torch.exp(2 * params["log_sigma_n"])), None

    def scalar(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    params = {
        "log_beta": torch.log(scalar(init_beta)),
        "log_sigma_f": scalar(0.0),
        "log_sigma_n": torch.log(scalar(init_noise)),
    }
    opt = AdamW(lr=lr)
    opt_state = opt.init(params)
    for _ in range(steps):
        _, _, grads = _value_and_grad(params, loss)
        params, opt_state = opt.update(grads, opt_state, params)

    with torch.no_grad():
        k_full = (evecs * spectrum(params)) @ evecs.T
    return params, k_full
