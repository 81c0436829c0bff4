"""Least time of the traced calls from their own inputs and outputs over
their wall time: the whole call's share of the chip's roofline (%)."""
from perfbench.harness import readers


def read(run):
    return readers.call_share_pct(run)
