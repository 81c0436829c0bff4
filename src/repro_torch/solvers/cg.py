"""Batched-RHS conjugate gradients (port of ``repro/solvers/cg.py``).

Solves H V = B for SPD ``H`` given only a matvec, with per-column scalars so
a batch of right-hand sides shares one loop.  The arithmetic of every
iteration is the JAX package's.  The adaptive loop keeps its stopping rule
exactly — continue while ``any(‖r‖ > tol·‖b‖)`` and under ``max_iters`` —
and reads that test on the host once per iteration.

Not in this slice: ``with_coeffs`` (the SLQ recurrence record), the
``"nystrom"``/``"auto"`` preconditioners and ``escalate=True``; each raises
NotImplementedError naming the slice that brings it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .strategy import SolveStrategy

_NYSTROM_SLICE = ("the Nyström/SLQ slice of the port (solvers/nystrom.py, "
                  "solvers/slq.py)")


class CGResult(NamedTuple):
    x: torch.Tensor          # [N] or [N, R] solution
    iters: int               # iterations executed
    resnorm: torch.Tensor    # [R] final residual norms
    converged: torch.Tensor  # [R] bool — per-column ‖r‖ ≤ tol·‖b‖ at exit
    precond_rank: int = 0    # Nyström rank of the preconditioner (0 = none/jacobi)


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
    while it < max_iters and bool(
            torch.any(torch.sqrt(dot(res, res)) > thresh)):
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
) -> CGResult:
    """Fixed-iteration CG (no early exit, no host reads inside the loop).

    ``tol`` only grades the reported ``converged`` field."""
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    dot = _dot if dot is None else dot
    apply_m = precond if precond is not None else jacobi_precond(precond_diag)

    bnorm2 = dot(b, b)
    x, res, z, p, rz = _init_state(matvec, b, x0, apply_m, dot)
    for _ in range(iters):
        hp = matvec(p)
        php = dot(p, hp)
        alpha = _safe_div(rz, php, (php > 0) & (rz > 0))
        x = x + alpha[None, :] * p
        res = res - alpha[None, :] * hp
        z = apply_m(res)
        rz_new = dot(res, z)
        beta = _safe_div(rz_new, rz, rz > 0)
        p = z + beta[None, :] * p
        rz = rz_new
    out = x[:, 0] if squeeze else x
    resnorm = torch.sqrt(dot(res, res))
    thresh = tol * torch.clamp(torch.sqrt(bnorm2), min=1e-30)
    return CGResult(out, iters, resnorm, resnorm <= thresh)


def make_preconditioner(
    h, strategy: SolveStrategy
) -> Callable[[torch.Tensor], torch.Tensor] | None:
    """The strategy's preconditioner apply for operator ``h``.

    ``"jacobi"`` uses ``h.diag_approx()`` when the operator exposes one
    (plain callables fall back to the identity — any SPD M is valid)."""
    if strategy.preconditioner in ("nystrom", "auto"):
        raise NotImplementedError(
            f"preconditioner={strategy.preconditioner!r} comes with "
            f"{_NYSTROM_SLICE}; this slice runs 'none' and 'jacobi'"
        )
    if strategy.preconditioner == "none":
        return None
    diag = h.diag_approx() if hasattr(h, "diag_approx") else None
    return jacobi_precond(diag)


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
    The preconditioner is built from the f32 operator; ``matvec_dtype``
    wraps only the CG matvec."""
    if escalate:
        raise NotImplementedError(
            "escalate=True comes with the observability and resilience slice "
            "of the port (solvers/escalate.py)"
        )
    if precond is None:
        precond = make_preconditioner(h, strategy)
    matvec = _with_matvec_dtype(h, strategy.matvec_dtype)
    if not strategy.warm_start:
        x0 = None
    if strategy.adaptive:
        return cg_solve(matvec, b, tol=strategy.tol,
                        max_iters=strategy.max_iters, dot=dot,
                        precond=precond, x0=x0)
    return cg_solve_fixed(matvec, b, iters=strategy.max_iters, dot=dot,
                          precond=precond, x0=x0, tol=strategy.tol)
