"""Device idle begun inside the build of Φ_x's column index
(``walks.column_index``), as a share of the traced window (%)."""
from perfbench.harness import spans


def read(run):
    return spans.idle_innermost_pct(run, "walks.column_index")
