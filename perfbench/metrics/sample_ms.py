"""Time per posterior request: the window's wall time over its requests (ms)."""
from perfbench.harness import readers


def read(run):
    return readers.per_unit_ms(run)
