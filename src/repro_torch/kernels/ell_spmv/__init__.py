from .ops import LAUNCHES, ell_spmv, ell_spmv_t, khat_fused  # noqa: F401
from .ref import ell_spmv_ref, ell_spmv_t_ref, khat_matvec_ref  # noqa: F401
