"""95th percentile of every posterior request's latency in the window (ms)."""
from perfbench.harness import readers


def read(run):
    return readers.latency_quantile_ms(run, 95)
