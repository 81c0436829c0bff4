"""The solver strategy config (port of ``repro/solvers/strategy.py``).

One frozen, hashable object holds every Krylov knob, so each consumer
passes a named strategy instead of tol/iters literals.  Same fields, same
validation and same named defaults as the JAX package.  ``solvers.solve``
runs all four preconditioners: ``"none"``, ``"jacobi"``, ``"nystrom"`` and
``"auto"``.
"""
from __future__ import annotations

import dataclasses

PRECONDITIONERS = ("none", "jacobi", "nystrom", "auto")
MATVEC_DTYPES = ("float32", "bfloat16")

# The Nyström pivot-budget default, and the ranks the "auto" preconditioner
# chooses between (0 = Jacobi) — the JAX package's values.
DEFAULT_PRECOND_RANK = 64
AUTO_RANKS = (0, 64, 128, 256)


@dataclasses.dataclass(frozen=True)
class SolveStrategy:
    """How to run a Krylov solve of H v = b.

    Attributes:
      tol: relative residual target ‖r‖ ≤ tol·‖b‖ (per RHS column).
      max_iters: iteration budget (exact trip count when ``adaptive=False``).
      preconditioner: ``"none"`` | ``"jacobi"`` (diag(H) approx) |
        ``"nystrom"`` (rank-r pivoted Nyström of K̂ via Woodbury) |
        ``"auto"`` (spectral probe picks a rank in AUTO_RANKS).
      warm_start: consumers that hold a previous solution pass it as
        ``x0``; strategies with ``warm_start=False`` make ``solve`` ignore
        any ``x0`` so cold/warm behaviour is decided in one place.
      adaptive: early exit on the residual test when True; a fixed trip
        count when False.
      precond_rank: Nyström pivot count r (clamped to the system size).
      precond_jitter: SPD jitter added to the r×r pivot Gram before its
        Cholesky.
      matvec_dtype: payload dtype for the H matvecs — ``"float32"`` or
        ``"bfloat16"`` (ELL payload in bf16; accumulation and the whole CG
        recurrence stay f32).
    """

    tol: float = 1e-5
    max_iters: int = 256
    preconditioner: str = "jacobi"
    warm_start: bool = False
    adaptive: bool = True
    precond_rank: int = DEFAULT_PRECOND_RANK
    precond_jitter: float = 1e-6
    matvec_dtype: str = "float32"

    def __post_init__(self):
        if self.preconditioner not in PRECONDITIONERS:
            raise ValueError(
                f"unknown preconditioner {self.preconditioner!r}; "
                f"valid: {PRECONDITIONERS}"
            )
        if self.matvec_dtype not in MATVEC_DTYPES:
            raise ValueError(
                f"unknown matvec_dtype {self.matvec_dtype!r}; "
                f"valid: {MATVEC_DTYPES}"
            )
        if self.max_iters < 1:
            raise ValueError(f"max_iters must be >= 1, got {self.max_iters}")
        if self.precond_rank < 1:
            raise ValueError(
                f"precond_rank must be >= 1, got {self.precond_rank}"
            )

    def with_(self, **updates) -> "SolveStrategy":
        """Functional update (strategies are frozen)."""
        return dataclasses.replace(self, **updates)

    def with_overrides(
        self,
        tol: float | None = None,
        max_iters: int | None = None,
        adaptive: bool | None = None,
    ) -> "SolveStrategy":
        """Fold legacy per-call-site literals into this strategy.

        ``None`` means "keep the strategy's value" — the one shim helper
        every consumer's deprecated ``cg_tol``/``cg_iters`` kwargs route
        through (duplicating this fold at call sites is how the six
        divergent literal sets happened in the first place)."""
        updates = {}
        if tol is not None:
            updates["tol"] = float(tol)
        if max_iters is not None:
            updates["max_iters"] = int(max_iters)
        if adaptive is not None:
            updates["adaptive"] = bool(adaptive)
        return dataclasses.replace(self, **updates) if updates else self


# The named strategies of the JAX package, with the same values.
MLL_DEFAULT = SolveStrategy(tol=1e-4, max_iters=256, warm_start=True)
POSTERIOR_DEFAULT = SolveStrategy(tol=1e-5, max_iters=512)
SHARDED_DEFAULT = SolveStrategy(tol=1e-5, max_iters=256)
SERVING_DEFAULT = SolveStrategy(tol=1e-6, max_iters=128, warm_start=True)
DRYRUN_DEFAULT = SolveStrategy(max_iters=64, adaptive=False)
