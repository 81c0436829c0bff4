"""walk_sample_kernel (every chunk's walks, both streamed passes, and Φ_x's
rows): least time of the traces written and graph rows read over its
device time (%)."""
from perfbench.harness import readers


def read(run):
    return readers.kernel_roofline_pct(run, "walk_sample",
                                       ("walk_sample_kernel",))
