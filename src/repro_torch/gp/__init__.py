from . import mll, posterior, variational  # noqa: F401
from .mll import (  # noqa: F401
    FitResult,
    exact_lml,
    fit_hyperparams,
    init_hyperparams,
    make_h_matvec,
    make_h_operator,
    mll_surrogate_loss,
    noise_var,
)
from .posterior import (  # noqa: F401
    gaussian_nlpd,
    pathwise_samples,
    pathwise_samples_chunked,
    posterior_mean,
    predictive_moments_from_samples,
    rmse,
)
from .variational import init_inducing_pivoted  # noqa: F401
