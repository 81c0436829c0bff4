from . import cg, mll, posterior, variational  # noqa: F401
from ..solvers import (  # noqa: F401  (the Krylov strategy layer)
    SolveStrategy,
    cg_solve_fixed,
    slq_logdet,
    solve,
)
from .cg import CGResult, cg_solve  # noqa: F401  (deprecation shim)
from .mll import (  # noqa: F401
    exact_lml,
    fit_hyperparams,
    init_hyperparams,
    make_h_matvec,
    make_h_operator,
    noise_var,
)
from .posterior import (  # noqa: F401
    gaussian_nlpd,
    pathwise_samples,
    posterior_mean,
    posterior_moments,
    predictive_moments_from_samples,
    rmse,
)
from .variational import init_inducing_pivoted  # noqa: F401
