from .ops import LAUNCHES, attention, flash_attention  # noqa: F401
from .ref import mha_chunked_ref, mha_ref  # noqa: F401
