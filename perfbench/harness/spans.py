"""Device-idle gaps of a traced slice, put down to the program's spans.

Whenever a torch profiler is recording, every ``obs.span`` of the program
(``repro_torch``) is a profiler range, even with obs disabled, so the
slice's host ranges carry the program's layer boundaries on the clock of
its device intervals.  A program span is a host range whose name starts
with one of ``PROGRAM``.

An idle gap is a hole in ``Trace.busy_intervals()`` within ``Trace.span``.
It is cut where a request's ``ROOT`` range opens or closes inside it, and
each piece is charged to the program spans open on the host at the piece's
start, above all to the innermost of them: a host read drains the device's
queue, and the device goes idle as the read returns, so the span that holds
the host when the gap begins is what left the device idle.  Charged where
it ends, the gap after each CG read would land on the next product's
launch.  The cuts keep the request's idle inside its root: the gap opened
by a request's last read is the read's until the root closes, the harness's
from there, and the next request's once its root opens.

A reader returns None where the slice has no device intervals (the CPU) or
no ``ROOT`` range (a program without these spans).
"""
from __future__ import annotations

import bisect

PROGRAM = ("posterior.", "features.", "walks.", "linops.", "solver.")
ROOT = "posterior.pathwise"


def gaps(trace) -> list:
    """(start, end) of each idle gap of the slice, in µs, in order."""
    lo, hi = trace.span
    out, last = [], lo
    for s, e in trace.busy_intervals():
        if s > last:
            out.append((last, s))
        last = max(last, e)
    if hi > last:
        out.append((last, hi))
    return out


def pieces(trace) -> list:
    """(start, end) of each idle gap of the slice, in µs, in order, cut
    where a ``ROOT`` range opens or closes inside it."""
    cuts = sorted({t for n, s, e in trace.host if n == ROOT for t in (s, e)})
    out = []
    for s, e in gaps(trace):
        for t in cuts[bisect.bisect_right(cuts, s):
                      bisect.bisect_left(cuts, e)]:
            out.append((s, t))
            s = t
        out.append((s, e))
    return out


def charged(trace) -> list:
    """(seconds, names) of each piece of idle (:func:`pieces`): the program
    spans open on the host at the piece's start, outermost first, innermost
    last."""
    ranges = sorted((s, e, n) for n, s, e in trace.host
                    if n.startswith(PROGRAM))
    out, open_, i = [], [], 0
    for s, e in pieces(trace):
        while i < len(ranges) and ranges[i][0] <= s:
            open_.append(ranges[i])
            i += 1
        open_ = [r for r in open_ if r[1] > s]
        names = tuple(n for _, _, n in sorted(open_,
                                              key=lambda r: (r[0], -r[1])))
        out.append(((e - s) * 1e-6, names))
    return out


def _spanned(trace) -> bool:
    return (trace is not None and trace.span is not None
            and any(n == ROOT for n, _, _ in trace.host))


def _idle_pct(run, charge) -> float | None:
    t = run.trace
    if not _spanned(t) or not t.device:
        return None
    idle = sum(s for s, names in charged(t) if charge(names))
    return 100.0 * idle / t.window_s


def idle_innermost_pct(run, name: str) -> float | None:
    """The share of the traced window (%) in pieces of idle begun while
    the innermost open program span was ``name``."""
    return _idle_pct(run, lambda names: names[-1:] == (name,))


def idle_within_pct(run, name: str) -> float | None:
    """The share of the traced window (%) in pieces of idle begun anywhere
    inside a ``name`` span."""
    return _idle_pct(run, lambda names: name in names)


def ranges_per_request(run, name: str) -> float | None:
    """The number of ``name`` ranges in the traced slice per request."""
    t = run.trace
    if not _spanned(t) or not t.requests:
        return None
    lo, hi = t.span
    n = sum(1 for m, s, _ in t.host if m == name and lo <= s < hi)
    return n / len(t.requests)
