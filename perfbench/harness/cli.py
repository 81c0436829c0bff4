"""One run of one cell of ``BENCHMARK.json``, printed as one JSON line.

    python3 perfbench/run.py --workload ring-1m.sample --seed 7 --seconds 20 --trace 0

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer ones, read from a profiled slice of
requests after the window.  The numbers compared with the reference are
printed, each beside its limit, as the last lines on standard error and
under ``checks``, the line's last key.  The run fails (exit code not 0, no
line) without a CUDA card, with fewer cards than the cell asks for, or
when JAX or the JAX package was imported.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

import torch

from . import runner, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card(device) -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def _number(x):
    return float(x) if x is not None and math.isfinite(float(x)) else None


def result_line(run: runner.Run, trace: bool, device) -> dict:
    cell = run.cell
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.reader.read(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    limits = cell.traffic["limits"]
    checks = {k: {"value": _number(run.checks.get(k)), "limit": lim}
              for k, lim in limits.items()}
    correct = run.window.failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": run.process_peak_bytes}
    line = {"correct": correct, "attempted": run.window.attempted,
            "failed": run.window.failed, "metrics": metrics, "device": dev}
    if trace and run.trace is not None and run.trace.span is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        line["breakdown"] = runner.breakdown(run.trace)
    line["checks"] = checks
    return line


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    build.BUILD_DIR = spec.ROOT / "build" / "repro_torch"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    run = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          device)
    line = result_line(run, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    line["device"]["power_limit"] = card(device)
    print(f"card: {line['device']['power_limit']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
