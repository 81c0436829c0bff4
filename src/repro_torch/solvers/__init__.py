"""The Krylov strategy layer (port of ``repro/solvers``; CG + Jacobi in this
slice)."""
from .cg import (  # noqa: F401
    CGResult,
    cg_solve,
    cg_solve_fixed,
    jacobi_precond,
    make_preconditioner,
    solve,
)
from .strategy import (  # noqa: F401
    AUTO_RANKS,
    DEFAULT_PRECOND_RANK,
    DRYRUN_DEFAULT,
    MATVEC_DTYPES,
    MLL_DEFAULT,
    POSTERIOR_DEFAULT,
    PRECONDITIONERS,
    SERVING_DEFAULT,
    SHARDED_DEFAULT,
    SolveStrategy,
)
