"""Structured observability for the port: metrics registry, spans, taps
and a JSONL flight recorder (port of ``repro/obs``, with the same names).

Quickstart::

    from repro_torch import obs

    with obs.recording("run.jsonl"):
        serve_loop.run(...)            # instrumented hot paths record
    print(obs.summary())               # p50/p95/p99 per span, counter totals

Validate or render a record with ``python -m repro_torch.obs.report
--validate run.jsonl`` / ``--summary run.jsonl``.  Disabled (the default)
costs one predicate per call site: spans, taps and counters return before
they touch a tensor, so nothing is read from the device and nothing is
synchronised."""
from .registry import (
    DEFAULT_BUCKETS,
    Histogram,
    JsonlSink,
    MetricsSink,
    REGISTRY,
    Registry,
    RingBufferSink,
    disable,
    emit_event,
    enable,
    enabled,
    gauge,
    get_registry,
    inc,
    log_buckets,
    observe,
    recording,
    reset_enabled,
    tap_scope,
)
from .report import summary, validate
from .spans import Span, span
from .taps import count, tap, tap_dict

__all__ = [
    "DEFAULT_BUCKETS",
    "Histogram",
    "JsonlSink",
    "MetricsSink",
    "REGISTRY",
    "Registry",
    "RingBufferSink",
    "Span",
    "count",
    "disable",
    "emit_event",
    "enable",
    "enabled",
    "gauge",
    "get_registry",
    "inc",
    "log_buckets",
    "observe",
    "recording",
    "reset_enabled",
    "span",
    "summary",
    "tap",
    "tap_dict",
    "tap_scope",
    "validate",
]
