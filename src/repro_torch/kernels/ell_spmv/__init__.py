from .ops import (  # noqa: F401
    LAUNCHES,
    ell_spmv,
    ell_spmv_raw,
    ell_spmv_t,
    ell_spmv_t_raw,
    khat_fused,
    khat_fused_raw,
)
from .ref import ell_spmv_ref, ell_spmv_t_ref, khat_matvec_ref  # noqa: F401
