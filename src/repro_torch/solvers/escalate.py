"""The solve-escalation ladder (port of ``repro/solvers/escalate.py``).

:func:`solve_escalate` retries a solve whose ``CGResult.converged`` came
back False with progressively stronger — and progressively more expensive
— strategies:

  rung 0: the caller's strategy, as-is                (baseline cost)
  rung 1: + Jacobi preconditioning, if it had none    (one diag, O(N))
  rung 2: + Nyström/auto preconditioning, if the      (rank-r pivoted
          operator supports it (nystrom.check_         factorisation,
          operator), warm-started                      O(N·r²) build)
  rung 3: 4× the iteration budget, warm-started       (pure iterations)
  rung 4: f32 matvecs, if the strategy ran bf16       (2× matvec bytes)

Every rung after the first is warm-started from the best iterate so far —
CG resumes from where it stalled, so escalation pays for the *remaining*
residual, not a fresh solve.  Host-level retries get capped attempts and
jittered exponential backoff (retry storms against a shared accelerator
are their own outage mode), and each attempt emits a ``solver.escalation``
obs event (``site: "solvers.solve"``) plus the attempts / resolved /
forced_stalls / exhausted counters.

Escalation is a *host* loop: it reads each attempt's ``converged`` flags
and worst residual between attempts.  The JAX package degrades to the
plain solve under an active trace; the port has no trace, so that branch
has no counterpart here.
"""
from __future__ import annotations

import random
import time
from typing import Callable

import torch

from .. import obs
from ..resilience import faults
from .cg import CGResult
from .cg import solve as _base_solve
from .strategy import SolveStrategy


def escalation_ladder(
    strategy: SolveStrategy, h=None
) -> list[SolveStrategy]:
    """The retry rungs for ``strategy`` against operator ``h``, cheapest
    first.  The Nyström rung is only offered when ``h`` can take it
    (``nystrom.check_operator`` — a ShiftedOperator over a materialised
    trace); dense and bare-callable systems skip to the iteration budget."""
    rungs = [strategy]
    s = strategy
    if s.preconditioner == "none":
        s = s.with_(preconditioner="jacobi", warm_start=True)
        rungs.append(s)
    if s.preconditioner in ("none", "jacobi") and h is not None:
        from .nystrom import check_operator

        if check_operator(h) is None:
            s = s.with_(preconditioner="auto", warm_start=True)
            rungs.append(s)
    s = s.with_(max_iters=s.max_iters * 4, warm_start=True)
    rungs.append(s)
    if s.matvec_dtype != "float32":
        s = s.with_(matvec_dtype="float32")
        rungs.append(s)
    return rungs


def solve_escalate(
    h,
    b: torch.Tensor,
    strategy: SolveStrategy = SolveStrategy(),
    *,
    x0: torch.Tensor | None = None,
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    max_attempts: int = 4,
    backoff: float = 0.02,
) -> CGResult:
    """Solve H v = b, climbing :func:`escalation_ladder` until converged.

    Same contract as :func:`repro_torch.solvers.solve` (which routes here
    under ``escalate=True``) — returns a standard :class:`CGResult`; on
    exhaustion it is the *best* attempt by worst-column residual, with
    ``converged`` honestly False.  A caller-prebuilt ``precond`` applies to
    the first attempt only; later rungs rebuild per their own strategy.
    ``backoff`` is the base of the jittered exponential host sleep between
    attempts (seconds)."""
    rungs = escalation_ladder(strategy, h)[: max(1, max_attempts)]
    best = None
    for attempt, s in enumerate(rungs):
        if attempt and backoff > 0:
            time.sleep(
                backoff * (2 ** (attempt - 1)) * (1.0 + random.random())
            )
        res = _base_solve(
            h, b, s, x0=x0, dot=dot,
            precond=precond if attempt == 0 else None,
        )
        stalled = faults.should_stall(attempt)
        if stalled:
            res = res._replace(converged=torch.zeros_like(res.converged))
            obs.inc("solver.escalation.forced_stalls")
        ok = bool(torch.all(res.converged))
        resnorm = float(torch.max(res.resnorm))
        obs.inc("solver.escalation.attempts")
        obs.emit_event({
            "type": "solver.escalation", "site": "solvers.solve",
            "attempt": attempt, "converged": ok, "forced_stall": stalled,
            "preconditioner": s.preconditioner, "max_iters": s.max_iters,
            "matvec_dtype": s.matvec_dtype, "resnorm_max": resnorm,
        })
        if best is None or resnorm < float(torch.max(best.resnorm)):
            best = res
        if ok:
            if attempt > 0:
                obs.inc("solver.escalation.resolved")
            return res
        # Resume the next rung from the best iterate so far — escalation
        # pays for the remaining residual, not a from-scratch solve.
        x0 = best.x
    obs.inc("solver.escalation.exhausted")
    return best
