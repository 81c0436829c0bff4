"""What the metric readers share.  A reader that finds nothing to read
returns None, and the metric is left out of the line."""
from __future__ import annotations

import statistics


def per_unit_ms(run):
    """The window's wall time over the units (requests or steps) it
    completed, in ms: all the work and all the time of the window."""
    w = run.window
    return 1e3 * w.wall_s / w.units if w.units else None


def latency_quantile_ms(run, q: int):
    """The q-th percentile of every request's latency in the window, ms."""
    lat = run.window.latencies_s
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=100, method="inclusive")[q - 1]


def _least(run, key: str) -> float:
    return sum(run.cell.driver.work(run.problem, out)[key]
               for out in run.trace.requests)


def kernel_roofline_pct(run, key: str, names):
    """The least time of the traced slice's ``key`` products over the device
    time of the kernels whose names hold one of ``names``."""
    if run.trace is None:
        return None
    dev_s = run.trace.kernel_s(names)
    if dev_s <= 0:
        return None
    return 100.0 * _least(run, key) / dev_s


def call_share_pct(run):
    """The traced calls' least time over the traced window."""
    if run.trace is None or run.trace.span is None:
        return None
    return 100.0 * _least(run, "call") / run.trace.window_s


def idle_pct(run):
    """1 − (union of device-activity intervals) / (traced window)."""
    t = run.trace
    if t is None or t.span is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
