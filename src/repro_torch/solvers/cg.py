"""Batched-RHS conjugate gradients (port of ``repro/solvers/cg.py``).

Solves H V = B for SPD ``H`` given only a matvec, with per-column scalars so
a batch of right-hand sides shares one loop.  The arithmetic of every
iteration is the JAX package's.  The adaptive loop keeps its stopping rule
exactly — continue while ``any(‖r‖ > tol·‖b‖)`` and under ``max_iters`` —
and reads that test on the host once per iteration.

``cg_solve_fixed(..., with_coeffs=True)`` records the recurrence scalars
(α_j, β_j) per column — the Lanczos tridiagonal of H that stochastic Lanczos
quadrature (solvers/slq.py) and the spectral rank probe
(solvers/nystrom.py) integrate.  :func:`solve` is the strategy entry point:
``"none"``, ``"jacobi"``, ``"nystrom"`` (the pivoted-Cholesky Nyström
preconditioner, applied by the Woodbury kernel) and ``"auto"`` (resolved to
a measured rank by the spectral probe).  Not in the port yet:
``escalate=True``, which raises NotImplementedError until the resilience
half of ROADMAP Queue 1 #5 ports ``solvers/escalate.py``.

Observability (when ``obs`` is enabled): every :func:`solve` records the
``solver.cg`` tap (iterations, worst residual, convergence, with the
strategy as metadata), and the loops record every 8th iteration's worst
residual norm as ``solver.cg.resnorm_traj``.  The adaptive loop takes that
value in the same device-to-host copy as its per-iteration stopping test;
the fixed loop, which reads nothing inside, keeps the sampled norms on the
device and reads them once after its last iteration.  Disabled, neither
loop reads more than it did without obs.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..obs import registry as _obs
from ..obs import taps as _obs_taps
from .strategy import SolveStrategy

_TRAJ = "solver.cg.resnorm_traj"
_TRAJ_SAMPLE = 8


class CGResult(NamedTuple):
    x: torch.Tensor          # [N] or [N, R] solution
    iters: int               # iterations executed
    resnorm: torch.Tensor    # [R] final residual norms
    converged: torch.Tensor  # [R] bool — per-column ‖r‖ ≤ tol·‖b‖ at exit
    precond_rank: int = 0    # Nyström rank of the preconditioner (0 = none/jacobi)


class LanczosCoeffs(NamedTuple):
    """CG recurrence scalars per iteration and RHS column.

    The Lanczos tridiagonal T of H in the Krylov basis of column j is
    (Saad, Iterative Methods §6.7)

        T[i, i]   = 1/α_i + β_{i-1}/α_{i-1}      (β_{-1}/α_{-1} := 0)
        T[i, i+1] = √β_i / α_i

    ``valid`` masks iterations executed before breakdown or convergence
    (α_i > 0); slq.py turns masked-off rows into decoupled unit eigenvalues
    that carry zero quadrature weight."""

    alphas: torch.Tensor   # [iters, R]
    betas: torch.Tensor    # [iters, R]
    valid: torch.Tensor    # [iters, R] bool
    bnorm2: torch.Tensor   # [R] squared probe norms (quadrature weights)


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(u * v, dim=0)


def jacobi_precond(precond_diag):
    """M⁻¹ from a diagonal; rows with a zero diagonal fall back to the
    identity instead of dividing by zero."""
    if precond_diag is None:
        return lambda v: v
    safe = torch.clamp(precond_diag, min=1e-30)
    inv = torch.where(precond_diag > 0, 1.0 / safe, torch.ones_like(safe))
    inv = inv[:, None]
    return lambda v: inv * v


def _init_state(matvec, b, x0, apply_m, dot):
    """Shared warm-startable CG initialisation: (x, r, z, p, rz)."""
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x0 = x0[:, None] if x0.dim() == b.dim() - 1 else x0
        x = torch.broadcast_to(x0, b.shape).to(b.dtype).clone()
        r = b - matvec(x)
    z = apply_m(r)
    return x, r, z, z, dot(r, z)


def _safe_div(num, den, ok):
    return torch.where(ok, num / torch.clamp(den, min=1e-30),
                       torch.zeros_like(num))


def _keep_going(resnorm: torch.Tensor, thresh: torch.Tensor, it: int) -> bool:
    """The adaptive loop's stopping test, any(‖r‖ > tol·‖b‖) — one host
    read.  When obs samples this iteration's residual (every 8th after the
    first), the worst norm rides in the same copy."""
    going = torch.any(resnorm > thresh)
    if it == 0 or not (_obs.enabled()
                       and _obs.REGISTRY.tap_tick(_TRAJ, _TRAJ_SAMPLE)):
        return bool(going)
    flag, worst = torch.stack([going.to(resnorm.dtype),
                               torch.max(resnorm)]).tolist()
    _obs_taps.tap(_TRAJ, worst)
    return bool(flag)


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    tol: float = 1e-5,
    max_iters: int = 256,
    precond_diag: torch.Tensor | None = None,
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    x0: torch.Tensor | None = None,
) -> CGResult:
    """Preconditioned CG with early exit.

    Args:
      matvec: V ↦ H V on [N, R] blocks.
      b: [N] or [N, R] right-hand sides.
      precond_diag: optional [N] Jacobi diagonal (M ≈ diag(H)).
      dot: column-wise inner product ([N,R],[N,R]) → [R].
      precond: optional preconditioner apply v ↦ M⁻¹v (takes precedence
        over ``precond_diag``).
      x0: optional warm start ([N] or [N, R]).
    """
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    dot = _dot if dot is None else dot
    apply_m = precond if precond is not None else jacobi_precond(precond_diag)

    bnorm = torch.sqrt(dot(b, b))
    thresh = tol * torch.clamp(bnorm, min=1e-30)

    x, res, z, p, rz = _init_state(matvec, b, x0, apply_m, dot)
    it = 0
    while it < max_iters and _keep_going(torch.sqrt(dot(res, res)), thresh,
                                         it):
        hp = matvec(p)
        php = dot(p, hp)
        alpha = _safe_div(rz, php, php > 0)
        x = x + alpha[None, :] * p
        res = res - alpha[None, :] * hp
        z = apply_m(res)
        rz_new = dot(res, z)
        beta = _safe_div(rz_new, rz, rz > 0)
        p = z + beta[None, :] * p
        rz = rz_new
        it += 1
    out = x[:, 0] if squeeze else x
    resnorm = torch.sqrt(dot(res, res))
    return CGResult(out, it, resnorm, resnorm <= thresh)


def cg_solve_fixed(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    iters: int,
    precond_diag: torch.Tensor | None = None,
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    tol: float = 1e-5,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    x0: torch.Tensor | None = None,
    with_coeffs: bool = False,
):
    """Fixed-iteration CG (no early exit, no host reads inside the loop).

    ``tol`` only grades the reported ``converged`` field.
    ``with_coeffs=True`` returns ``(CGResult, LanczosCoeffs)``: α, β and
    the ``active`` mask of every iteration, which SLQ integrates."""
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    dot = _dot if dot is None else dot
    apply_m = precond if precond is not None else jacobi_precond(precond_diag)

    bnorm2 = dot(b, b)
    x, res, z, p, rz = _init_state(matvec, b, x0, apply_m, dot)
    if with_coeffs:
        alphas = b.new_zeros((iters, b.shape[1]))
        betas = torch.zeros_like(alphas)
        valid = torch.zeros_like(alphas, dtype=torch.bool)
    traj = []   # sampled worst residual norms, read once after the loop
    for i in range(iters):
        hp = matvec(p)
        php = dot(p, hp)
        active = (php > 0) & (rz > 0)
        alpha = _safe_div(rz, php, active)
        x = x + alpha[None, :] * p
        res = res - alpha[None, :] * hp
        z = apply_m(res)
        rz_new = dot(res, z)
        beta = _safe_div(rz_new, rz, rz > 0)
        p = z + beta[None, :] * p
        rz = rz_new
        if with_coeffs:
            alphas[i], betas[i], valid[i] = alpha, beta, active
        if _obs.enabled() and _obs.REGISTRY.tap_tick(_TRAJ, _TRAJ_SAMPLE):
            traj.append(torch.max(torch.sqrt(dot(res, res))))
    if traj:
        for worst in torch.stack(traj).tolist():
            _obs_taps.tap(_TRAJ, worst)
    out = x[:, 0] if squeeze else x
    resnorm = torch.sqrt(dot(res, res))
    thresh = tol * torch.clamp(torch.sqrt(bnorm2), min=1e-30)
    result = CGResult(out, iters, resnorm, resnorm <= thresh)
    if with_coeffs:
        return result, LanczosCoeffs(alphas, betas, valid, bnorm2)
    return result


def make_preconditioner(
    h, strategy: SolveStrategy
) -> Callable[[torch.Tensor], torch.Tensor] | None:
    """The strategy's preconditioner apply for operator ``h``.

    ``"jacobi"`` uses ``h.diag_approx()`` when the operator exposes one
    (plain callables fall back to the identity — any SPD M is valid).
    ``"nystrom"`` needs a square materialised-trace :class:`ShiftedOperator`
    (solvers/nystrom.py says why).  ``"auto"`` resolves here (spectral probe
    → measured rank) when called directly; :func:`solve` resolves it before
    reaching this point."""
    from .nystrom import nystrom_precond, resolve_strategy

    strategy = resolve_strategy(h, strategy)
    if strategy.preconditioner == "none":
        return None
    if strategy.preconditioner == "jacobi":
        diag = h.diag_approx() if hasattr(h, "diag_approx") else None
        return jacobi_precond(diag)
    return nystrom_precond(h, rank=strategy.precond_rank,
                           jitter=strategy.precond_jitter)


def _with_matvec_dtype(h, dtype: str):
    """Apply the strategy's matvec precision to the operator: operators cast
    their payload (``with_matvec_dtype``); a bare callable gets its operand
    cast, with the output restored to the recurrence dtype."""
    if dtype == "float32":
        return h
    if hasattr(h, "with_matvec_dtype"):
        return h.with_matvec_dtype(dtype)
    d = getattr(torch, dtype)
    return lambda v: h(v.to(d)).to(v.dtype)


def solve(
    h,
    b: torch.Tensor,
    strategy: SolveStrategy = SolveStrategy(),
    *,
    x0: torch.Tensor | None = None,
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    escalate: bool = False,
) -> CGResult:
    """Solve H v = b under a :class:`SolveStrategy` — the one entry point.

    ``h`` is an operator (callable, optionally with ``diag_approx``) or a
    bare matvec.  ``precond`` overrides the strategy's preconditioner with a
    prebuilt apply.  ``x0`` is honoured only when ``strategy.warm_start``.

    ``preconditioner="auto"`` resolves here, by the spectral probe
    (solvers/nystrom.py); the port has no trace, so it always measures.  The
    preconditioner is built from the f32 operator; ``matvec_dtype`` wraps
    only the CG matvec, and the rank actually used is reported as
    ``CGResult.precond_rank``.  ``escalate=True`` raises NotImplementedError
    until the resilience half of ROADMAP Queue 1 #5 ports
    solvers/escalate.py."""
    if escalate:
        raise NotImplementedError(
            "escalate=True comes with the port's resilience slice, the "
            "second half of ROADMAP Queue 1 #5 (solvers/escalate.py, with "
            "the fault hooks, the journal and the checkpoint manager); the "
            "observability half is ported"
        )
    if strategy.preconditioner == "auto":
        from .nystrom import resolve_strategy

        strategy = resolve_strategy(h, strategy)
    if precond is None:
        precond = make_preconditioner(h, strategy)
    rank = int(getattr(precond, "rank", 0))
    matvec = _with_matvec_dtype(h, strategy.matvec_dtype)
    if not strategy.warm_start:
        x0 = None
    if strategy.adaptive:
        res = cg_solve(matvec, b, tol=strategy.tol,
                       max_iters=strategy.max_iters, dot=dot,
                       precond=precond, x0=x0)
    else:
        res = cg_solve_fixed(matvec, b, iters=strategy.max_iters, dot=dot,
                             precond=precond, x0=x0, tol=strategy.tol)
    res = res._replace(precond_rank=rank)
    _tap_solve(res, strategy)
    return res


def _tap_solve(res: CGResult, strategy: SolveStrategy) -> None:
    """Per-solve diagnostics into the obs registry (no-op, and no device
    read, when disabled): iters into the ``solver.cg.iters`` histogram,
    all-columns convergence as a counter, the worst column's residual as a
    gauge, with the solve configuration as tap metadata."""
    if not _obs.enabled():
        return
    _obs_taps.tap_dict(
        "solver.cg",
        {
            "iters": res.iters,
            "resnorm_max": torch.max(res.resnorm),
            "converged": torch.all(res.converged),
        },
        hist=("iters",),
        meta={
            "preconditioner": strategy.preconditioner,
            "precond_rank": res.precond_rank,
            "matvec_dtype": strategy.matvec_dtype,
            "adaptive": strategy.adaptive,
            "tol": strategy.tol,
            "max_iters": strategy.max_iters,
        },
    )
