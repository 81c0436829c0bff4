"""Nyström inducing selection (port of the part of
``repro/gp/variational.py`` that the solver stack shares).

:func:`init_inducing_pivoted` picks inducing nodes by the greedy
residual-diagonal pivot rule of the Nyström preconditioner
(``solvers.pivot_rows``), so SVGP inducing selection and CG preconditioning
anchor on the same rows.  The SVGP model itself (``kernel_blocks``,
``elbo``, ``fit_svgp``, ``predict_svgp``) is not ported yet (ROADMAP Queue 1
#4).
"""
from __future__ import annotations

import torch

from ..core.walks import WalkTrace
from ..solvers import pivot_rows


def init_inducing_pivoted(trace: WalkTrace, f: torch.Tensor,
                          n_inducing: int) -> torch.Tensor:
    """Inducing set by Nyström pivoting: greedy residual-diagonal selection.

    Returns **row indices into ``trace``** (node ids for a full-graph trace;
    for a sub-trace, map them through the rows that built it).  Greedy
    residual pivoting spreads the budget across correlated row clusters
    instead of stacking onto the highest-energy one."""
    return pivot_rows(trace, f, n_inducing)
