"""Device idle share of the traced slice: 1 − busy union / window (%)."""
from perfbench.harness import readers


def read(run):
    return readers.idle_pct(run)
