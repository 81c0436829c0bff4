"""Device idle begun inside CG's host read of its stopping test
(``solver.cg.read``), as a share of the traced window (%)."""
from perfbench.harness import spans


def read(run):
    return spans.idle_innermost_pct(run, "solver.cg.read")
