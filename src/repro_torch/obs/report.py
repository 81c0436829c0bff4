"""Flight-record reporting: summary tables + JSONL schema validation (port
of ``repro/obs/report.py``).

Two consumers:

  * examples/benches call :func:`summary` at exit to print a human-readable
    table (per-span p50/p95/p99, counter totals, gauges) from the live
    registry — replacing ad-hoc ``print`` timing lines;
  * CI validates the recorded artifact:
    ``python -m repro_torch.obs.report --validate run.jsonl`` exits non-zero
    unless the file is non-empty, every line parses, the ``meta`` and
    ``summary`` records are present, and every event carries its type's
    required fields.  ``--summary run.jsonl`` renders the same table from
    the recorded summary, so a flight record is readable without rerunning
    anything.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import registry

# Required fields per event type — the JSONL schema the validator (and the
# round-trip test) enforce.  It is the JAX package's plus the
# ``solver.escalation`` event that both packages' escalation ladders emit
# (and the JAX validator does not list), so a record of either package
# validates here.  Every event additionally carries (t, seq).
EVENT_SCHEMA = {
    "meta": ("jax_version", "host_backend", "spmv_backend"),
    "span": ("name", "path", "depth", "dur_s", "blocked"),
    "tap": ("name", "values"),
    "fit_step": ("step", "loss", "cg_iters", "cg_converged"),
    "solver.escalation": ("site", "attempt", "converged", "forced_stall"),
    "summary": ("metrics",),
}


def _fmt_dur(s) -> str:
    if s is None:
        return "-"
    if s >= 1.0:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.2f}ms"
    return f"{s * 1e6:.0f}us"


def _fmt_val(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def summary(snapshot: dict | None = None) -> str:
    """Render the registry snapshot as an aligned text table.

    Spans (histograms named ``span.*``) print count/p50/p95/p99/total in
    human time units; other histograms print their raw-unit stats;
    counters and gauges print name/value."""
    snap = snapshot if snapshot is not None else registry.REGISTRY.snapshot()
    lines = []
    spans = {
        k[len("span."):]: v
        for k, v in snap.get("histograms", {}).items()
        if k.startswith("span.")
    }
    others = {
        k: v
        for k, v in snap.get("histograms", {}).items()
        if not k.startswith("span.")
    }
    if spans:
        lines.append("-- spans " + "-" * 51)
        lines.append(
            f"{'name':<28}{'count':>7}{'p50':>9}{'p95':>9}{'p99':>9}"
            f"{'total':>9}"
        )
        for name in sorted(spans):
            h = spans[name]
            lines.append(
                f"{name:<28}{h['count']:>7}{_fmt_dur(h['p50']):>9}"
                f"{_fmt_dur(h['p95']):>9}{_fmt_dur(h['p99']):>9}"
                f"{_fmt_dur(h['sum']):>9}"
            )
    if others:
        lines.append("-- histograms " + "-" * 46)
        lines.append(
            f"{'name':<28}{'count':>7}{'p50':>9}{'p95':>9}{'p99':>9}"
            f"{'max':>9}"
        )
        for name in sorted(others):
            h = others[name]
            lines.append(
                f"{name:<28}{h['count']:>7}{_fmt_val(h['p50']):>9}"
                f"{_fmt_val(h['p95']):>9}{_fmt_val(h['p99']):>9}"
                f"{_fmt_val(h['max']):>9}"
            )
    counters = snap.get("counters", {})
    if counters:
        lines.append("-- counters " + "-" * 48)
        for name in sorted(counters):
            lines.append(f"{name:<44}{_fmt_val(counters[name]):>16}")
    gauges = snap.get("gauges", {})
    if gauges:
        lines.append("-- gauges " + "-" * 50)
        for name in sorted(gauges):
            lines.append(f"{name:<44}{_fmt_val(gauges[name]):>16}")
    if not lines:
        lines.append("(no metrics recorded)")
    return "\n".join(lines)


def read_events(path: str) -> list[dict]:
    """Parse every JSONL line; raises ValueError naming the bad line."""
    events = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: unparseable line ({e})")
    return events


def validate(path: str) -> list[str]:
    """Schema-check a flight record; returns human-readable violations.

    An empty list means the artifact is valid: non-empty, parseable, every
    event typed with its required fields, ``meta`` first and exactly one
    trailing ``summary`` carrying the metrics snapshot."""
    try:
        events = read_events(path)
    except (OSError, ValueError) as e:
        return [str(e)]
    errors = []
    if not events:
        return [f"{path}: flight record is empty"]
    for i, ev in enumerate(events):
        etype = ev.get("type")
        if etype not in EVENT_SCHEMA:
            errors.append(f"event {i}: unknown type {etype!r}")
            continue
        for field in ("t", "seq"):
            if field not in ev:
                errors.append(f"event {i} ({etype}): missing {field!r}")
        for field in EVENT_SCHEMA[etype]:
            if field not in ev:
                errors.append(f"event {i} ({etype}): missing {field!r}")
    if events[0].get("type") != "meta":
        errors.append("first record is not 'meta'")
    summaries = [ev for ev in events if ev.get("type") == "summary"]
    if len(summaries) != 1:
        errors.append(f"expected exactly one 'summary' record, "
                      f"found {len(summaries)}")
    elif events[-1].get("type") != "summary":
        errors.append("'summary' is not the final record")
    elif not isinstance(summaries[0].get("metrics"), dict):
        errors.append("'summary' carries no metrics snapshot")
    return errors


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--validate", metavar="PATH",
                        help="schema-check a JSONL flight record")
    parser.add_argument("--summary", metavar="PATH",
                        help="render the summary table of a flight record")
    args = parser.parse_args(argv)
    rc = 0
    if args.validate:
        errors = validate(args.validate)
        for err in errors:
            print(err)
        if errors:
            rc = 1
        else:
            n = len(read_events(args.validate))
            print(f"{args.validate}: valid flight record ({n} events)")
    if args.summary:
        events = read_events(args.summary)
        summaries = [ev for ev in events if ev.get("type") == "summary"]
        if not summaries:
            print(f"{args.summary}: no summary record")
            rc = 1
        else:
            print(summary(summaries[-1]["metrics"]))
    if not args.validate and not args.summary:
        parser.print_help()
    return rc


if __name__ == "__main__":
    sys.exit(main())
