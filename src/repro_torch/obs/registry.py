"""Host-side metrics registry, sinks and the enablement switch (port of
``repro/obs/registry.py``).

The registry is the single accumulation point for everything the
observability layer measures: **counters** (monotone totals — queries
served, walk rows sampled), **gauges** (last-value signals — queue depth,
current loss) and **histograms** with *fixed log-spaced buckets* (latency
and iteration distributions; fixed edges make two runs' histograms
mergeable and the JSONL schema stable).  Metric updates are a dict write
under a lock.

Events (span ends, tap records) additionally stream to every attached
:class:`MetricsSink`:

  * :class:`RingBufferSink` — last-n events in memory (the default when
    observability is enabled without a recording path);
  * :class:`JsonlSink` — the **flight recorder**: every event appended as
    one JSON line, ``meta`` record first and a ``summary`` record (full
    registry snapshot) last, so the artifact is self-describing
    (obs/report.py renders and validates it).  The schema is the JAX
    package's, so either package's validator reads either's records.

Enablement resolves context override > process global > ``REPRO_OBS`` env
var > disabled.  **Disabled is the default and costs one predicate**: every
span, tap and counter call checks :func:`enabled` first and then returns,
reading nothing from the device.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import threading
import time
from contextvars import ContextVar
from typing import Protocol

# ---------------------------------------------------------------------------
# Enablement (context > global > env > off).
# ---------------------------------------------------------------------------

_global_enabled: bool | None = None
_override: ContextVar[bool | None] = ContextVar("repro_obs_enabled", default=None)


def enabled() -> bool:
    """Resolve the observability switch (context > global > env > False).

    Read by every span, tap and counter call before anything else — a
    False here records nothing and reads nothing from the device."""
    ov = _override.get()
    if ov is not None:
        return ov
    if _global_enabled is not None:
        return _global_enabled
    return os.environ.get("REPRO_OBS", "").lower() in ("1", "true", "on")


def enable() -> None:
    """Enable observability process-wide (metrics + taps + spans)."""
    global _global_enabled
    _global_enabled = True


def disable() -> None:
    """Disable observability process-wide (the zero-overhead default)."""
    global _global_enabled
    _global_enabled = False


def reset_enabled() -> None:
    """Restore env-var/default resolution (mainly for tests)."""
    global _global_enabled
    _global_enabled = None


@contextlib.contextmanager
def tap_scope(flag: bool):
    """Pin :func:`enabled` to ``flag`` for the duration of the context
    (context beats the process global and the env var)."""
    token = _override.set(bool(flag))
    try:
        yield
    finally:
        _override.reset(token)


# ---------------------------------------------------------------------------
# Histogram buckets.
# ---------------------------------------------------------------------------


def log_buckets(
    lo: float = 1e-7, hi: float = 1e3, per_decade: int = 5
) -> tuple[float, ...]:
    """Fixed log-spaced bucket upper edges covering [lo, hi].

    A value v lands in the first bucket whose edge satisfies v <= edge
    (values above ``hi`` land in the implicit overflow bucket).  Fixed
    edges — not data-dependent ones — keep histograms mergeable across
    runs and the JSONL schema stable; the default spans 100ns..1000s at 5
    buckets/decade, wide enough for span latencies *and* CG iteration
    counts (<= 1000)."""
    n_decades = math.log10(hi / lo)
    n = int(round(n_decades * per_decade))
    return tuple(lo * 10.0 ** (k / per_decade) for k in range(n + 1))


DEFAULT_BUCKETS = log_buckets()


class Histogram:
    """Counts over fixed log-spaced buckets + exact count/sum/min/max.

    Percentiles are estimated by geometric interpolation inside the bucket
    the quantile falls in, clamped to the exact observed [min, max] — at
    5 buckets/decade the edge ratio is 10^(1/5) ~= 1.58, so p50/p95/p99
    carry at most ~±26% bucket error, plenty for latency triage."""

    __slots__ = ("edges", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.edges = tuple(buckets)
        self.counts = [0] * (len(self.edges) + 1)   # +1: overflow bucket
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        # First bucket whose edge >= v (bisect on the sorted edge tuple);
        # v above every edge falls through to the overflow slot.
        lo, hi = 0, len(self.edges)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.edges[mid] >= v:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def percentile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]) from the bucket counts."""
        if self.count == 0:
            return math.nan
        target = q * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                frac = max(0.0, min(1.0, (target - seen) / c))
                if i == 0:
                    lo_edge = self.edges[0] / 10.0 if self.edges else self.vmin
                    hi_edge = self.edges[0] if self.edges else self.vmax
                elif i == len(self.edges):
                    lo_edge, hi_edge = self.edges[-1], self.vmax
                else:
                    lo_edge, hi_edge = self.edges[i - 1], self.edges[i]
                if lo_edge <= 0 or hi_edge <= 0:
                    est = lo_edge + frac * (hi_edge - lo_edge)
                else:
                    est = lo_edge * (hi_edge / lo_edge) ** frac
                return min(max(est, self.vmin), self.vmax)
            seen += c
        return self.vmax

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
            "p50": self.percentile(0.50) if self.count else None,
            "p95": self.percentile(0.95) if self.count else None,
            "p99": self.percentile(0.99) if self.count else None,
        }


# ---------------------------------------------------------------------------
# Sinks.
# ---------------------------------------------------------------------------


class MetricsSink(Protocol):
    """Where events (spans, taps) stream; attach via Registry.add_sink."""

    def emit(self, event: dict) -> None: ...

    def close(self) -> None: ...


class RingBufferSink:
    """Keep the last ``capacity`` events in memory (bounded, allocation-free
    steady state) — the default sink when obs is enabled without a path."""

    def __init__(self, capacity: int = 4096):
        self.events: collections.deque[dict] = collections.deque(
            maxlen=capacity
        )

    def emit(self, event: dict) -> None:
        self.events.append(event)

    def close(self) -> None:
        self.events.clear()


class JsonlSink:
    """The flight recorder: one JSON object per line, appended as events
    arrive.  Lines are flushed per event — a crashed run keeps everything
    recorded up to the crash, which is the point of a flight recorder."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a")

    def emit(self, event: dict) -> None:
        self._fh.write(json.dumps(event, default=str) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------


def _key(name: str, labels: dict | None) -> str:
    """Fold labels into the metric key: ``name{k=v,...}`` (sorted, stable)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Registry:
    """Thread-safe metric store + event fan-out.

    One process-global instance (:data:`REGISTRY`) backs the whole obs
    layer; tests may construct private ones.  All methods are safe to call
    from several threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}
        self._sinks: list[MetricsSink] = []
        self._seq = 0
        self._tap_ticks: dict[str, int] = {}

    # -- metrics -------------------------------------------------------------
    def inc(self, name: str, n: float = 1, labels: dict | None = None) -> None:
        key = _key(name, labels)
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def set_gauge(
        self, name: str, value: float, labels: dict | None = None
    ) -> None:
        with self._lock:
            self.gauges[_key(name, labels)] = float(value)

    def observe(
        self,
        name: str,
        value: float,
        labels: dict | None = None,
        buckets: tuple[float, ...] | None = None,
    ) -> None:
        key = _key(name, labels)
        with self._lock:
            hist = self.histograms.get(key)
            if hist is None:
                hist = self.histograms[key] = Histogram(
                    buckets if buckets is not None else DEFAULT_BUCKETS
                )
            hist.observe(value)

    def tap_tick(self, name: str, sample: int) -> bool:
        """Host-side sampling: True on every ``sample``-th call per name."""
        if sample <= 1:
            return True
        with self._lock:
            tick = self._tap_ticks.get(name, 0)
            self._tap_ticks[name] = tick + 1
        return tick % sample == 0

    # -- events --------------------------------------------------------------
    def emit(self, event: dict) -> None:
        """Stamp (t, seq) and fan the event out to every sink."""
        with self._lock:
            seq = self._seq
            self._seq += 1
            sinks = tuple(self._sinks)
        event = {"t": time.time(), "seq": seq, **event}
        for sink in sinks:
            sink.emit(event)

    def add_sink(self, sink: MetricsSink) -> None:
        with self._lock:
            self._sinks.append(sink)

    def remove_sink(self, sink: MetricsSink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    # -- lifecycle -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Point-in-time copy of every metric (the ``summary`` payload)."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {
                    k: h.snapshot() for k, h in self.histograms.items()
                },
            }

    def reset(self) -> None:
        """Drop all metrics and sampling state (sinks stay attached)."""
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()
            self._tap_ticks.clear()
            self._seq = 0


REGISTRY = Registry()


def get_registry() -> Registry:
    return REGISTRY


# Module-level conveniences that honour the enablement switch — host-side
# call sites use these so the disabled path is one predicate check.


def inc(name: str, n: float = 1, labels: dict | None = None) -> None:
    if enabled():
        REGISTRY.inc(name, n, labels)


def gauge(name: str, value: float, labels: dict | None = None) -> None:
    if enabled():
        REGISTRY.set_gauge(name, value, labels)


def observe(
    name: str,
    value: float,
    labels: dict | None = None,
    buckets: tuple[float, ...] | None = None,
) -> None:
    if enabled():
        REGISTRY.observe(name, value, labels, buckets)


def emit_event(event: dict) -> None:
    if enabled():
        REGISTRY.emit(event)


# ---------------------------------------------------------------------------
# Recording: the one-flag flight-recorder entry point.
# ---------------------------------------------------------------------------


def _meta_record() -> dict:
    """The run's ``meta`` record.  It carries the schema's three keys:
    ``jax_version`` is None (the port runs no JAX), ``host_backend`` the
    device kind entry points run on ("cuda" unless no card is present) and
    ``spmv_backend`` "by-device" (a CUDA tensor takes the kernel, a CPU
    tensor the plain version; kernels/dispatch.py).  The torch version and
    the card's name say what ran."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "type": "meta",
        "jax_version": None,
        "host_backend": "cuda" if cuda else "cpu",
        "spmv_backend": "by-device",
        "torch_version": torch.__version__,
        "device_name": torch.cuda.get_device_name(0) if cuda else "cpu",
        "pid": os.getpid(),
    }


@contextlib.contextmanager
def recording(path: str | None = None, ring: int = 4096, fresh: bool = True):
    """Enable observability and (optionally) stream a JSONL flight record.

        with obs.recording("run.jsonl"):
            ...instrumented workload...

    Writes a ``meta`` record first, every span/tap event as it happens, and
    a final ``summary`` record holding the full registry snapshot — a
    self-describing trace of the run (validate/render with
    ``python -m repro_torch.obs.report``).  With ``path=None`` only the in-memory
    ring buffer records events.  ``fresh=True`` (default) resets the
    registry on entry so the exit summary covers exactly this window.

    Yields the active :class:`Registry`.  Restores the previous enablement
    state on exit, so recordings nest inside explicitly-disabled scopes
    without leaking."""
    global _global_enabled
    if fresh:
        REGISTRY.reset()
    sinks: list[MetricsSink] = [RingBufferSink(ring)]
    if path is not None:
        sinks.append(JsonlSink(path))
    for sink in sinks:
        REGISTRY.add_sink(sink)
    prev = _global_enabled
    _global_enabled = True
    REGISTRY.emit(_meta_record())
    try:
        yield REGISTRY
    finally:
        REGISTRY.emit({"type": "summary", "metrics": REGISTRY.snapshot()})
        _global_enabled = prev
        for sink in sinks:
            REGISTRY.remove_sink(sink)
            sink.close()
