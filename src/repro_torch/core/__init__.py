"""Paper core: graph random features for scalable GP covariance estimation."""
from . import features, kernels_exact, linops, modulation, walks  # noqa: F401
from .features import (  # noqa: F401
    feature_values,
    khat_cross_matvec,
    khat_diag_approx,
    khat_matvec,
    materialize_khat,
    materialize_phi,
    phi_matvec,
    phi_t_matvec,
    take_rows,
)
from .linops import (  # noqa: F401
    KhatOperator,
    PhiOperator,
    ShiftedOperator,
)
from .modulation import Modulation, diffusion, learnable, matern  # noqa: F401
from .walks import WalkTrace, sample_walks, sample_walks_for_nodes  # noqa: F401
