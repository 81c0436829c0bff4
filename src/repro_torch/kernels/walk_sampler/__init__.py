from .ops import LAUNCHES, walk_sample  # noqa: F401
from .ref import walk_block, walk_sample_ref  # noqa: F401
from .rng import counter_bits, counter_uniform, fmix32  # noqa: F401
