from .ops import LAUNCHES, walk_sample, walk_sample_vals  # noqa: F401
from .ref import walk_block, walk_sample_ref, walk_sample_vals_ref  # noqa: F401
from .rng import counter_bits, counter_uniform, fmix32  # noqa: F401
