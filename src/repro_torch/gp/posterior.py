"""Posterior inference with pathwise conditioning (port of
``repro/gp/posterior.py``; paper §3.2, Eq. 12).

A posterior sample over *all* N nodes is a prior sample plus a sparse
correction:  g|y = g + K̂_{·x}(K̂_xx + σ²I)⁻¹(y − g(x) − ε),
with the prior sampled as g = Φ w, w ~ N(0, I_N)  (Cov = ΦΦᵀ = K̂).
Every product is an O(N) sparse op; the solve is CG through the strategy
layer — pass ``strategy=SolveStrategy(preconditioner="nystrom")`` to
precondition the training-block system with the rank-r pivoted Nyström of
K̂_xx, or ``"auto"`` to let the spectral probe pick the rank.  The JAX
package resolves ``"auto"`` before its jit boundary on an eagerly built
copy of H; the port has no jit boundary, so ``solvers.solve`` resolves it
on the operator it is handed.

The public sampling functions draw the prior weights ``w`` [N, S] and the
unit-normal noise ``eps`` [T, S] from a ``torch.Generator`` (w first) and
hand them to an inner function that takes them as arguments; the JAX
package draws both inside its jit.  :func:`posterior_moments` is the
closed-form Eq. 3/4 of a serving state (``serving/state.py``).

Observability (when ``obs`` is enabled): :func:`posterior_mean`,
:func:`pathwise_samples` and :func:`pathwise_samples_chunked` are the
``posterior.mean``, ``posterior.pathwise`` and
``posterior.pathwise_chunked`` spans, each blocked on its result; the
draws of w and eps are the ``posterior.draw`` span.
"""
from __future__ import annotations

import math

import torch

from .. import obs, solvers
from ..core import features, linops, walks
from ..core.walks import DEFAULT_CHUNK, WalkConfig, WalkTrace
from ..graphs.formats import Graph
from ..solvers import SolveStrategy
from .mll import make_h_operator


def _resolve(strategy, cg_tol, cg_iters) -> SolveStrategy:
    if strategy is None:
        strategy = solvers.POSTERIOR_DEFAULT
    return strategy.with_overrides(tol=cg_tol, max_iters=cg_iters)


def _noise(sigma_n2, obs_mask):
    """σ² (scalar) or, with a mask, σ² on live slots and 1e6 on padding."""
    if obs_mask is None:
        return sigma_n2
    s2 = torch.as_tensor(sigma_n2, dtype=torch.float32, device=obs_mask.device)
    return torch.where(obs_mask > 0, s2, torch.full_like(s2, 1e6))


def _sqrt(sigma_n2, like: torch.Tensor):
    # float32 sqrt of float32 σ², as jnp.sqrt of a Python float computes it.
    return torch.sqrt(torch.as_tensor(sigma_n2, dtype=torch.float32,
                                      device=like.device))


def _draw(generator: torch.Generator, n: int, t: int, n_samples: int,
          device: torch.device):
    """Prior weights w [N, S] then unit noise eps [T, S], from ``generator``
    on its own device, moved to ``device``."""
    gdev = generator.device
    with obs.span("posterior.draw"):
        w = torch.randn((n, n_samples), generator=generator, device=gdev,
                        dtype=torch.float32)
        eps = torch.randn((t, n_samples), generator=generator, device=gdev,
                          dtype=torch.float32)
        return w.to(device), eps.to(device)


def posterior_mean(
    trace: WalkTrace,
    train_nodes: torch.Tensor,
    f: torch.Tensor,
    sigma_n2,
    y: torch.Tensor,
    cg_tol: float | None = None,
    cg_iters: int | None = None,
    obs_mask: torch.Tensor | None = None,
    strategy: SolveStrategy | None = None,
) -> torch.Tensor:
    """MAP prediction m = K̂_{·x} (K̂_xx + σ²I)⁻¹ y over all N nodes (Eq. 3).

    ``obs_mask`` enables static-shape padding (padded slots ⇒ ∞ noise)."""
    strategy = _resolve(strategy, cg_tol, cg_iters)
    n = trace.n_nodes
    noise = _noise(sigma_n2, obs_mask)
    if obs_mask is not None:
        y = y * obs_mask
    with obs.span("posterior.mean") as sp:
        trace_x = features.take_rows(trace, train_nodes)
        h = make_h_operator(trace_x, f, noise, n)
        alpha = solvers.solve(h, y, strategy).x
        out = linops.khat_cross(trace, trace_x, f, n).matvec(alpha)
        sp.block_on(out)
    return out


def pathwise_samples(
    trace: WalkTrace,
    train_nodes: torch.Tensor,
    f: torch.Tensor,
    sigma_n2,
    y: torch.Tensor,
    generator: torch.Generator,
    n_samples: int = 16,
    cg_tol: float | None = None,
    cg_iters: int | None = None,
    obs_mask: torch.Tensor | None = None,
    strategy: SolveStrategy | None = None,
    return_diagnostics: bool = False,
):
    """Draw ``n_samples`` joint posterior samples over all N nodes (Eq. 12).

    Returns [N, n_samples]; with ``return_diagnostics=True`` also
    (iters_used, converged) of the inner CG solve."""
    with obs.span("posterior.pathwise", n_samples=n_samples) as sp:
        w, eps = _draw(generator, trace.n_nodes, train_nodes.shape[0],
                       n_samples, trace.cols.device)
        samples, iters, converged = _pathwise_samples(
            trace, train_nodes, f, sigma_n2, y, w, eps, obs_mask,
            _resolve(strategy, cg_tol, cg_iters),
        )
        sp.block_on(samples)
    if return_diagnostics:
        return samples, iters, converged
    return samples


def _pathwise_samples(trace, train_nodes, f, sigma_n2, y, w, eps, obs_mask,
                      strategy):
    """Eq. 12 on a materialised trace, given w [N, S] and unit eps [T, S]."""
    n = trace.n_nodes
    noise = _noise(sigma_n2, obs_mask)
    g = linops.phi(trace, f, n).matvec(w)                      # prior sample
    g_x = g[train_nodes.long()]
    resid = y[:, None] - (g_x + _sqrt(sigma_n2, g) * eps)
    if obs_mask is not None:
        resid = resid * obs_mask[:, None]

    trace_x = features.take_rows(trace, train_nodes)
    h = make_h_operator(trace_x, f, noise, n)
    sol = solvers.solve(h, resid, strategy)
    samples = g + linops.khat_cross(trace, trace_x, f, n).matvec(sol.x)
    return samples, sol.iters, bool(torch.all(sol.converged))


def pathwise_samples_chunked(
    graph: Graph,
    train_nodes: torch.Tensor,
    f: torch.Tensor,
    sigma_n2,
    y: torch.Tensor,
    generator: torch.Generator,
    walk_seed: int,
    cfg: WalkConfig,
    *,
    chunk: int = DEFAULT_CHUNK,
    n_samples: int = 16,
    cg_tol: float | None = None,
    cg_iters: int | None = None,
    obs_mask: torch.Tensor | None = None,
    strategy: SolveStrategy | None = None,
    return_diagnostics: bool = False,
):
    """Eq. 12 over all N nodes with the full-graph Φ *never materialised*.

    The prior draw g = Φw and the cross correction K̂_{·x}u stream Φ in
    ``chunk``-row blocks; only the training-node trace Φ_x ([T, K]) is
    materialised.  With the same ``walk_seed`` and the same generator state
    this equals :func:`pathwise_samples` on the monolithic trace sampled with
    ``walk_seed``.  Peak memory: O(chunk·K + N·n_samples).

    The training-block solve is a strategy solve on the *materialised*
    Φ_x, so Nyström preconditioning works here even though the full Φ is
    lazy."""
    with obs.span("posterior.pathwise_chunked", n_samples=n_samples,
                  chunk=chunk) as sp:
        w, eps = _draw(generator, graph.n_nodes, train_nodes.shape[0],
                       n_samples, graph.device)
        samples, iters, converged = _pathwise_samples_chunked(
            graph, train_nodes, f, sigma_n2, y, w, eps, walk_seed, cfg, chunk,
            obs_mask, _resolve(strategy, cg_tol, cg_iters),
        )
        sp.block_on(samples)
    if return_diagnostics:
        return samples, iters, converged
    return samples


def _pathwise_samples_chunked(graph, train_nodes, f, sigma_n2, y, w, eps,
                              walk_seed, cfg, chunk, obs_mask, strategy):
    """Chunked Eq. 12, given w [N, S] and unit eps [T, S]."""
    n = graph.n_nodes
    noise = _noise(sigma_n2, obs_mask)
    g = linops.chunked_phi(graph, f, walk_seed, cfg, chunk).matvec(w)
    g_x = g[train_nodes.long()]
    resid = y[:, None] - (g_x + _sqrt(sigma_n2, g) * eps)
    if obs_mask is not None:
        resid = resid * obs_mask[:, None]

    trace_x = walks.sample_walks_for_nodes(
        graph, train_nodes, walk_seed,
        cfg.n_walkers, cfg.p_halt, cfg.l_max, cfg.reweight, cfg.scheme,
    )
    h = make_h_operator(trace_x, f, noise, n)
    sol = solvers.solve(h, resid, strategy)
    cross = linops.chunked_khat_cross(graph, trace_x, f, walk_seed, cfg, chunk)
    return g + cross.matvec(sol.x), sol.iters, bool(torch.all(sol.converged))


def predictive_moments_from_samples(samples: torch.Tensor):
    """Ensemble mean/variance over pathwise samples → scalable Eq. 3/4 proxy."""
    return torch.mean(samples, dim=1), torch.var(samples, dim=1, correction=0)


def posterior_moments(state, query_nodes):
    """*Exact* closed-form Eq. 3/4 from a serving state's cached Cholesky.

    The no-CG counterpart of :func:`predictive_moments_from_samples`: the
    GP's exact predictive mean and variance under the GRF estimator,
    μ = K̂_{q,x}(K̂_xx+σ²I)⁻¹y and σ² = K̂_qq − K̂_{q,x}(K̂_xx+σ²I)⁻¹K̂_{x,q},
    in O(q·m²) via two triangular solves (``repro_torch.serving.state``).
    ``state`` is a :class:`repro_torch.serving.ServeState`.  Returns
    (mean[q], var[q])."""
    from ..serving import state as serving_state

    return serving_state.posterior_moments(state, query_nodes)


def gaussian_nlpd(y: torch.Tensor, mean: torch.Tensor,
                  var: torch.Tensor) -> torch.Tensor:
    """Average negative log predictive density (paper's NLPD metric)."""
    var = torch.clamp(var, min=1e-10)
    return torch.mean(0.5 * torch.log(2 * math.pi * var)
                      + 0.5 * (y - mean) ** 2 / var)


def rmse(y: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((y - mean) ** 2))
