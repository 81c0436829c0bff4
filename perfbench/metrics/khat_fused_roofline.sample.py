"""khat_fused (khat_segments + khat_gather): least time of the traced K̂
products over their device time (%)."""
from perfbench.harness import readers


def read(run):
    return readers.kernel_roofline_pct(run, "khat_fused",
                                       ("khat_segments", "khat_gather"))
