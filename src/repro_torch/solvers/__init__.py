"""The Krylov strategy layer (port of ``repro/solvers``): CG, Jacobi and
pivoted-Cholesky Nyström preconditioning, the ``"auto"`` rank probe, SLQ
log-determinants and the solve-escalation ladder."""
from .cg import (  # noqa: F401
    CGResult,
    LanczosCoeffs,
    cg_solve,
    cg_solve_fixed,
    jacobi_precond,
    make_preconditioner,
    solve,
)
from .escalate import (  # noqa: F401
    escalation_ladder,
    solve_escalate,
)
from .nystrom import (  # noqa: F401
    nystrom_precond,
    pivot_rows,
    probe_spectrum,
    resolve_strategy,
    select_rank,
)
from .slq import (  # noqa: F401
    logdet_from_coeffs,
    rademacher,
    slq_logdet,
    tridiag_from_coeffs,
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
