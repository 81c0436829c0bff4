"""Deprecation shim — the Krylov stack lives in :mod:`repro_torch.solvers`
(port of ``repro/gp/cg.py``).

``from repro_torch.gp.cg import cg_solve`` keeps working, with a
``DeprecationWarning`` the first time any shimmed entry point runs (once
per process, not per call); new code uses ``repro_torch.solvers.solve``
under a :class:`repro_torch.solvers.SolveStrategy`, or the low-level
``cg_solve`` / ``cg_solve_fixed`` there.  The strategy surface is
re-exported too, so code on the old import path sees the same API.
"""
from __future__ import annotations

import functools
import warnings

from ..solvers import (  # noqa: F401  (re-exports, unchanged API)
    AUTO_RANKS,
    CGResult,
    DEFAULT_PRECOND_RANK,
    MATVEC_DTYPES,
    PRECONDITIONERS,
    SolveStrategy,
    resolve_strategy,
    select_rank,
)
from ..solvers import cg as _cg

_WARNED = False


def _deprecated(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        global _WARNED
        if not _WARNED:
            _WARNED = True
            warnings.warn(
                f"repro_torch.gp.cg.{fn.__name__} is deprecated; use "
                f"repro_torch.solvers.{fn.__name__} (or "
                "repro_torch.solvers.solve with a SolveStrategy)",
                DeprecationWarning,
                stacklevel=2,
            )
        return fn(*args, **kwargs)

    return wrapper


cg_solve = _deprecated(_cg.cg_solve)
cg_solve_fixed = _deprecated(_cg.cg_solve_fixed)
