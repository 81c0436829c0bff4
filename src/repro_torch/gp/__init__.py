from . import mll, posterior  # noqa: F401
from .mll import (  # noqa: F401
    init_hyperparams,
    make_h_matvec,
    make_h_operator,
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
