"""The device idle of a cell's traced slice, split by the program's spans.

    python3 perfbench/tools/split.py --workload ring-1m.sample --seed 7 --seconds 5
    python3 perfbench/tools/split.py --workload ring-1m.sample --seed 7 --seconds 5 --timeline 1

One traced run of the cell through the harness's own ``run_cell``, on the
card.  Each piece of device idle (``harness/spans.py``) is put down to the
innermost program span open at its start and summed, in ms a request, into
the columns of ``PERF.md`` §5:

  * ``solver.cg.read``: CG's host reads of its stopping test;
  * ``walks.column_index``: the builds of Φ_x's column index;
  * ``cg_iterations``: the rest of CG's loop (``solver.cg``, its
    iterations, their K̂ products), which the host's launch rate paces;
  * ``rest_of_request``: the rest of ``posterior.pathwise``;
  * ``harness``: between requests.

It prints one JSON line: that split, the same idle by innermost span name,
each program span's ranges a request, and any program span name found among
the device ops (a range mirrored onto the device timeline and counted as
device work; there should be none).  ``--timeline K`` adds the request K's
idle pieces over 20 µs in order, each with its innermost program span and
the innermost host op of any name open at its start.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

GROUPS = ("solver.cg.read", "walks.column_index", "cg_iterations",
          "rest_of_request", "harness")


def group(names: tuple) -> str:
    """The column of ``PERF.md`` §5 for a piece charged to ``names``."""
    from perfbench.harness import spans

    if not names:
        return "harness"
    if names[-1] in GROUPS:
        return names[-1]
    if "solver.cg" in names:
        return "cg_iterations"
    if spans.ROOT in names:
        return "rest_of_request"
    return "harness"


def _innermost(host: list, times: list) -> list:
    """The innermost host op of any name open at each of the ascending
    ``times``."""
    ranges = sorted((s, e, n) for n, s, e in host)
    out, open_, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            open_.append(ranges[i])
            i += 1
        open_ = [r for r in open_ if r[1] > t]
        best = max(open_, key=lambda r: (r[0], -r[1]), default=None)
        out.append(best[2] if best else "(none)")
    return out


def split(trace, timeline: int | None = None, min_us: float = 20.0) -> dict:
    """The split of ``trace``'s idle (see the module's docstring); the
    timeline of request ``timeline`` lists its pieces over ``min_us``."""
    from perfbench.harness import spans

    n = len(trace.requests)
    by_group = dict.fromkeys(GROUPS, 0.0)
    by_name: dict[str, float] = {}
    charged = spans.charged(trace)
    for sec, names in charged:
        by_group[group(names)] += sec
        key = names[-1] if names else "(harness)"
        by_name[key] = by_name.get(key, 0.0) + sec
    counts: dict[str, int] = {}
    for name, _, _ in trace.host:
        if name.startswith(spans.PROGRAM):
            counts[name] = counts.get(name, 0) + 1
    per = 1e3 / n
    out = {
        "requests": n,
        "window_ms_per_request": trace.window_s * per,
        "idle_ms_per_request": sum(sec for sec, _ in charged) * per,
        "split_ms_per_request": {k: v * per for k, v in by_group.items()},
        "by_innermost_ms_per_request": {
            k: v * per for k, v in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])},
        "ranges_per_request": {k: v / n for k, v in sorted(counts.items())},
        "program_names_among_device_ops": sorted(
            {name for name, _, _ in trace.device
             if name.startswith(spans.PROGRAM)}),
    }
    roots = sorted((s, e) for name, s, e in trace.host if name == spans.ROOT)
    if timeline is not None and timeline + 1 < len(roots):
        lo, hi = roots[timeline][0], roots[timeline + 1][0]
        pieces = spans.pieces(trace)
        ops = _innermost(trace.host, [s for s, _ in pieces])
        out["timeline"] = [
            [round((s - lo) * 1e-3, 3), round((e - s) * 1e-3, 3),
             names[-1] if names else "(harness)", op]
            for (s, e), (_, names), op in zip(pieces, charged, ops)
            if lo <= s < hi and e - s > min_us]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--timeline", type=int, default=None,
                    help="also list this request's idle pieces in order")
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import runner, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("split: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    build.BUILD_DIR = spec.ROOT / "build" / "repro_torch"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    run = runner.run_cell(cell, args.seed, args.seconds, True, device)
    line = {"workload": cell.name, "seed": args.seed,
            "checks": run.checks, **split(run.trace, args.timeline)}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parents[2]
    build_dir = ROOT / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(build_dir / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build_dir / "torch_extensions")
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
