from .ops import LAUNCHES, apply  # noqa: F401
from .ref import rmsnorm_ref  # noqa: F401
