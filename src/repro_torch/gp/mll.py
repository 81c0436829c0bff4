"""Hyperparameter learning by iterative log-marginal-likelihood ascent
(port of ``repro/gp/mll.py``; paper §3.2, Eq. 8–11).

The gradient Eq. 9 comes from autograd of a *surrogate* built from
gradient-free CG solves:

    s(θ) = −½ v_yᵀ H(θ) v_y + ½·mean_s v_sᵀ H(θ) z_s,
    v_y = H⁻¹ y,  v_s = H⁻¹ z_s  (z_s Rademacher probes, Eq. 10),

with v detached, so ∇s = ∇(−L) (Hutchinson estimate).  The solves run under
``torch.no_grad()`` on an operator built from detached f and σ_n²; the two
H matvecs of the surrogate differentiate through the fused K̂ kernel's
autograd Function, whose backward runs the Φᵀ scatter kernel.

Warm starts as in the JAX package: ``_fit_chunk`` carries the solution
block [v_y, v_z] from step to step as ``x0`` and draws the probes once per
chunk.  The JAX ``lax.scan`` over Adam steps is a Python loop here.

Under ``preconditioner="nystrom"`` each step's solve rebuilds the
preconditioner from that step's operator, as the JAX ``_fit_chunk`` does
under jit; ``"auto"`` is resolved once per fit, on the initial
hyperparameters.  The LML *value* (not only its gradient) comes from
:func:`exact_lml`: a strategy solve for yᵀH⁻¹y and stochastic Lanczos
quadrature (solvers/slq.py) for log det H.

Observability (when ``obs`` is enabled): each chunk of Adam steps is an
``mll.fit_chunk`` span, and every step sets the ``mll.loss`` and
``mll.sigma_n2`` gauges, lands in the ``mll.cg_iters`` histogram, bumps
``mll.steps`` (and ``mll.cg_nonconverged``) and emits a ``fit_step`` event
— all from the values the history already reads.  :func:`exact_lml` is an
``mll.exact_lml`` span.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from .. import device as _device
from .. import obs, solvers
from ..core import linops
from ..core.modulation import Modulation
from ..core.walks import WalkTrace
from ..optim.adamw import AdamW, tree_leaves, tree_map
from ..solvers import SolveStrategy


def init_hyperparams(mod: Modulation, generator: torch.Generator | None = None,
                     init_noise: float = 0.1, device=None) -> dict:
    """{"mod": modulation params, "log_sigma_n": log σ_n} on ``device``."""
    dev = _device.resolve(device)
    return {
        "mod": mod.init(generator, device=dev),
        "log_sigma_n": torch.log(torch.tensor(init_noise, dtype=torch.float32,
                                              device=dev)),
    }


def noise_var(params: dict) -> torch.Tensor:
    return torch.exp(2.0 * params["log_sigma_n"])


def make_h_operator(
    trace_x: WalkTrace, f: torch.Tensor, sigma_n2, n_nodes: int
) -> linops.ShiftedOperator:
    """H = K̂_xx + D as an operator; ``sigma_n2`` is a scalar (σ_n² I) or a
    [T] vector (heteroscedastic diagonal)."""
    return linops.shifted(trace_x, f, sigma_n2, n_nodes)


def make_h_matvec(
    trace_x: WalkTrace, f: torch.Tensor, sigma_n2, n_nodes: int
) -> Callable:
    """Callable view of :func:`make_h_operator` (operators are callable)."""
    return make_h_operator(trace_x, f, sigma_n2, n_nodes)


def _masked_noise(sigma_n2: torch.Tensor, obs_mask: torch.Tensor | None):
    """σ_n² on live slots and 1e6 on static-shape padding (or the scalar)."""
    if obs_mask is None:
        return sigma_n2
    return torch.where(obs_mask > 0, sigma_n2, torch.full_like(obs_mask, 1e6))


def mll_surrogate_loss(
    params: dict,
    generator: torch.Generator | None,
    trace_x: WalkTrace,
    mod: Modulation,
    y: torch.Tensor,
    n_nodes: int,
    n_probes: int = 8,
    cg_tol: float | None = None,
    cg_iters: int | None = None,
    obs_mask: torch.Tensor | None = None,
    strategy: SolveStrategy | None = None,
    probes: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
):
    """Returns (surrogate_loss, aux).  ∇ surrogate == ∇ negative-LML (est.).

    ``obs_mask``: optional float [T], 1 for live observations and 0 for
    static-shape padding (padding gets ~infinite noise and zero probes).
    ``probes`` fixes the Rademacher block z [T, n_probes] (otherwise drawn
    from ``generator``) and ``x0`` warm-starts the solve; aux["v"] is the
    detached solution block to carry."""
    if strategy is None:
        strategy = solvers.MLL_DEFAULT.with_(warm_start=x0 is not None)
    strategy = strategy.with_overrides(tol=cg_tol, max_iters=cg_iters)
    f = mod(params["mod"])
    sigma_n2_scalar = noise_var(params)
    sigma_n2 = _masked_noise(sigma_n2_scalar, obs_mask)
    t = y.shape[0]
    if obs_mask is not None:
        y = y * obs_mask
    if probes is None:
        probes = solvers.rademacher(generator, (t, n_probes), y.dtype,
                                    device=y.device)
    z = probes
    if obs_mask is not None:
        z = z * obs_mask[:, None]
    b = torch.cat([y[:, None], z], dim=1)

    # The solve is H⁻¹b at a stopped gradient: no_grad records nothing, and
    # f goes in as it is, needing a gradient, so that the solve reads the
    # slot payload as the gradient products below do (linops._coalesced).
    with torch.no_grad():
        h_sg = make_h_operator(trace_x, f, sigma_n2.detach(), n_nodes)
        sol = solvers.solve(h_sg, b, strategy, x0=x0)
    v = sol.x.detach()
    v_y, v_z = v[:, 0], v[:, 1:]

    h = make_h_operator(trace_x, f, sigma_n2, n_nodes)
    hv_y = h.matvec(v_y)
    hz = h.matvec(z)
    term_fit = -0.5 * torch.dot(v_y, hv_y)
    term_tr = 0.5 * torch.mean(torch.sum(v_z * hz, dim=0))
    loss = term_fit + term_tr
    aux = {
        "datafit": 0.5 * torch.dot(y, v_y),     # ½ yᵀH⁻¹y (true value)
        "cg_iters": sol.iters,
        "cg_resnorm": torch.max(sol.resnorm),
        "cg_converged": torch.all(sol.converged),
        "sigma_n2": sigma_n2_scalar.detach(),
        "v": v,
    }
    return loss, aux


@dataclasses.dataclass
class FitResult:
    params: dict
    history: list


def _value_and_grad(params, fn):
    """(loss, aux, grads) of ``fn(params)`` with grads shaped like params."""
    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    leaves = tree_leaves(p)
    loss, aux = fn(p)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(x) if g is None else g
              for x, g in zip(leaves, grads))
    return loss.detach(), aux, tree_map(lambda _: next(it), p)


def _fit_chunk(
    params, opt_state, generator, trace_x, y, obs_mask, v0,
    *, mod, opt, n_nodes, n_probes, strategy, chunk, probes=None,
):
    """``chunk`` Adam steps (the JAX ``lax.scan``, as a Python loop).

    Warm starts: when ``strategy.warm_start`` the previous step's solution
    block v = [v_y, v_z] is fed back as ``x0`` and the probes are drawn ONCE
    per chunk; the probe columns of the incoming ``v0`` solved the previous
    chunk's probes, so they are reset to a cold start here (the v_y column
    stays: y never changes).  ``probes`` [T, n_probes] lets a caller supply
    a warm chunk's draw; otherwise they come from ``generator`` (once per
    step when cold).

    Returns (params, opt_state, v, traces) with traces a tuple of per-step
    (loss, datafit, sigma_n2, cg_iters, cg_converged) lists."""
    warm = strategy.warm_start
    if probes is not None and not warm:
        raise ValueError("caller-supplied probes need a warm-started strategy; "
                         "a cold chunk draws its probes per step")
    if warm:
        if probes is None:
            probes = solvers.rademacher(generator, (y.shape[0], n_probes),
                                        y.dtype, device=y.device)
        v0 = torch.cat([v0[:, :1], torch.zeros_like(v0[:, 1:])], dim=1)
    traces = ([], [], [], [], [])
    v_prev = v0
    for _ in range(chunk):

        def loss_fn(p, x0=v_prev if warm else None):
            return mll_surrogate_loss(
                p, generator, trace_x, mod, y, n_nodes, n_probes=n_probes,
                obs_mask=obs_mask, strategy=strategy, probes=probes,
                x0=x0,
            )

        loss, aux, grads = _value_and_grad(params, loss_fn)
        params, opt_state = opt.update(grads, opt_state,
                                       tree_map(torch.Tensor.detach, params))
        v_prev = aux["v"]
        for out, x in zip(traces, (loss, aux["datafit"], aux["sigma_n2"],
                                   aux["cg_iters"], aux["cg_converged"])):
            out.append(x)
    return params, opt_state, v_prev, traces


def fit_hyperparams(
    trace_x: WalkTrace,
    mod: Modulation,
    y: torch.Tensor,
    n_nodes: int,
    generator: torch.Generator,
    steps: int = 100,
    lr: float = 0.05,
    n_probes: int = 8,
    cg_tol: float | None = None,
    cg_iters: int | None = None,
    init_params: dict | None = None,
    init_noise: float = 0.1,
    obs_mask: torch.Tensor | None = None,
    chunk: int = 10,
    strategy: SolveStrategy | None = None,
) -> FitResult:
    """Adam ascent on the LML (paper §3.2 'hyperparameter learning').

    ``strategy`` defaults to the cold-started ``solvers.MLL_DEFAULT`` shape
    with ``cg_tol``/``cg_iters`` folded in; pass ``solvers.MLL_DEFAULT``
    (``warm_start=True``) to carry [v_y, v_z] across Adam steps.  Probes
    come from ``generator``, drawn on its device, once per chunk when warm.

    ``preconditioner="auto"`` is resolved ONCE, on the initial
    hyperparameters with probes from ``generator``, and the measured rank
    is reused for every step (H only drifts by hyperparameter updates).

    ``FitResult.history`` records EVERY step (loss, datafit, σ_n², CG
    iterations and convergence)."""
    if strategy is None:
        strategy = solvers.MLL_DEFAULT.with_(warm_start=False)
    strategy = strategy.with_overrides(tol=cg_tol, max_iters=cg_iters)
    if init_params is None:
        init_params = init_hyperparams(mod, generator, init_noise,
                                       device=y.device)
    params = init_params
    opt = AdamW(lr=lr)
    opt_state = opt.init(params)
    if obs_mask is None:
        obs_mask = torch.ones_like(y)
    if strategy.preconditioner == "auto":
        with torch.no_grad():
            f0 = mod(params["mod"])
            s2 = _masked_noise(noise_var(params), obs_mask)
            strategy = solvers.resolve_strategy(
                make_h_operator(trace_x, f0, s2, n_nodes), strategy,
                generator=generator)
    v = torch.zeros((y.shape[0], 1 + n_probes), dtype=torch.float32,
                    device=y.device)

    history = []
    done = 0
    while done < steps:
        this = min(chunk, steps - done)
        with obs.span("mll.fit_chunk", steps=this) as sp:
            params, opt_state, v, traces = _fit_chunk(
                params, opt_state, generator, trace_x, y, obs_mask, v,
                mod=mod, opt=opt, n_nodes=n_nodes, n_probes=n_probes,
                strategy=strategy, chunk=this,
            )
            sp.block_on(traces)
        loss_t, fit_t, s2_t, iters_t, conv_t = traces
        for j in range(this):
            rec = {"step": done + j + 1, "loss": float(loss_t[j]),
                   "datafit": float(fit_t[j]), "sigma_n2": float(s2_t[j]),
                   "cg_iters": int(iters_t[j]),
                   "cg_converged": bool(conv_t[j])}
            history.append(rec)
            obs.gauge("mll.loss", rec["loss"])
            obs.gauge("mll.sigma_n2", rec["sigma_n2"])
            obs.observe("mll.cg_iters", rec["cg_iters"])
            obs.inc("mll.steps")
            if not rec["cg_converged"]:
                obs.inc("mll.cg_nonconverged")
            obs.emit_event({"type": "fit_step", **rec})
        done += this
    return FitResult(params=params, history=history)


# ---------------------------------------------------------------------------
# Exact LML values (SLQ log-det) — the quantity the surrogate only
# differentiates.
# ---------------------------------------------------------------------------


def _lml_operator(trace_x, f, sigma_n2, n_nodes, obs_mask):
    """H of :func:`exact_lml`: K̂ + σ²I, or with a mask M K̂ M + D with unit
    noise on dead slots (their rows of H are exactly e_i, so log det H is
    the live block's)."""
    if obs_mask is None:
        return make_h_operator(trace_x, f, sigma_n2, n_nodes)
    s2 = torch.as_tensor(sigma_n2, dtype=torch.float32, device=obs_mask.device)
    noise = torch.where(obs_mask > 0, s2, torch.ones_like(obs_mask))
    return linops.ShiftedOperator(linops.khat(trace_x, f, n_nodes), noise,
                                  mask=obs_mask)


@torch.no_grad()
def exact_lml(
    trace_x: WalkTrace,
    f: torch.Tensor,
    sigma_n2,
    y: torch.Tensor,
    n_nodes: int,
    generator: torch.Generator,
    strategy: SolveStrategy | None = None,
    n_probes: int = 32,
    slq_iters: int = 64,
    obs_mask: torch.Tensor | None = None,
) -> dict:
    """log p(y | θ) = −½ yᵀH⁻¹y − ½ log det H − (T/2) log 2π  (Eq. 8).

    The quadratic term is a strategy solve; the log-det is stochastic
    Lanczos quadrature over the CG recurrence (solvers/slq.py) — no dense
    factorisation, O(n_probes · slq_iters) sparse matvecs.  Probes come from
    ``generator`` (also the ``"auto"`` probe's, when the strategy asks for
    it).  With ``obs_mask`` the operator takes the masked-sandwich form
    M K̂ M + D with unit noise on dead slots, so the result is the
    live-block LML.

    Returns a dict with ``lml``, ``datafit`` (½yᵀH⁻¹y), ``logdet`` and the
    solve's ``converged`` flag (an unconverged quadratic term means the lml
    value is untrustworthy)."""
    if strategy is None:
        strategy = solvers.MLL_DEFAULT.with_(warm_start=False)
    if strategy.preconditioner == "auto":
        strategy = solvers.resolve_strategy(
            _lml_operator(trace_x, f, sigma_n2, n_nodes, obs_mask), strategy,
            generator=generator)
    with obs.span("mll.exact_lml") as sp:
        out = _exact_lml(trace_x, f, sigma_n2, y, obs_mask, generator,
                         strategy=strategy, n_probes=n_probes,
                         slq_iters=slq_iters, n_nodes=n_nodes)
        sp.block_on(out)
    return out


def _exact_lml(trace_x, f, sigma_n2, y, obs_mask, generator, *, strategy,
               n_probes, slq_iters, n_nodes):
    t = y.shape[0]
    if obs_mask is None:
        t_live = torch.tensor(float(t), device=y.device)
    else:
        t_live = torch.sum(obs_mask)
        y = y * obs_mask
    h = _lml_operator(trace_x, f, sigma_n2, n_nodes, obs_mask)
    sol = solvers.solve(h, y, strategy)
    datafit = 0.5 * torch.dot(y, sol.x)
    logdet = solvers.slq_logdet(h, t, generator, n_probes=n_probes,
                                n_iters=slq_iters, device=y.device)
    lml = -datafit - 0.5 * logdet - 0.5 * t_live * math.log(2.0 * math.pi)
    return {
        "lml": lml,
        "datafit": datafit,
        "logdet": logdet,
        "converged": bool(torch.all(sol.converged)),
    }
