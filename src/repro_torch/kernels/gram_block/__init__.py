from .ops import LAUNCHES, gram_block, gram_block_raw  # noqa: F401
from .ref import gram_block_ref, gram_lookup_ref  # noqa: F401
