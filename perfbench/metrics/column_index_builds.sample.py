"""Builds of Φ_x's column index (``walks.column_index`` ranges) per traced
request."""
from perfbench.harness import spans


def read(run):
    return spans.ranges_per_request(run, "walks.column_index")
