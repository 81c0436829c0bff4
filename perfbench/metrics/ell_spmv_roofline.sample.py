"""ell_spmv_rows (the prior draw Φw): least time over device time (%)."""
from perfbench.harness import readers


def read(run):
    return readers.kernel_roofline_pct(run, "ell_spmv", ("ell_spmv_rows",))
