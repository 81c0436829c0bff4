"""On the card: the control at the cells' own size fails the limits on
three seeds (``perfbench/calibrate.py``'s readings; PERF.md has the
numbers the limits were set from)."""
import pytest

from perfbench import calibrate
from perfbench.harness import spec

SEEDS = (2147480101, 2147480102, 2147480103)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ring-1m.sample", "sphere-1m.track"])
def test_control_fails_at_the_cells_size(name, card):
    cell = spec.load_cell(name)
    limits = cell.traffic["limits"]
    for seed in SEEDS:
        checks = calibrate.readings(cell, seed, True, card)["checks"]
        assert any(checks[k] > lim for k, lim in limits.items())
