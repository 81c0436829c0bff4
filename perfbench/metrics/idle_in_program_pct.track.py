"""Device idle inside the request (``posterior.pathwise``): gaps begun in
it, up to the root's close, as a share of the traced window (%); the rest
of ``device_idle_pct`` lies between requests, in the harness."""
from perfbench.harness import spans


def read(run):
    return spans.idle_within_pct(run, "posterior.pathwise")
