from .ops import LAUNCHES, woodbury_apply, woodbury_apply_raw  # noqa: F401
from .ref import woodbury_apply_ref  # noqa: F401
