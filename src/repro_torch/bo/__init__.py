"""Thompson-sampling BO over graph nodes and its search baselines."""
from . import baselines, thompson  # noqa: F401
from .thompson import (  # noqa: F401
    BOState,
    thompson_sampling,
    thompson_sampling_incremental,
)
