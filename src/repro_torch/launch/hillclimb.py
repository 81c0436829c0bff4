"""Hillclimb runner (port of ``repro/launch/hillclimb.py``): rerun a dry-run
cell with config overrides and record the roofline next to (not over) the
baseline record, under ``build/repro_torch/perf/<tag>/``.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --arch deepseek-v2-236b --shape decode_32k --set mla_absorb=true --tag absorb
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os

from ..configs import get_config
from .dryrun import ARTIFACT_DIR, production_mesh, run_cell, run_gp_cell


def parse_override(kv: str):
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("true", "True"):
        return k, True
    if v in ("false", "False"):
        return k, False
    return k, v


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--set", nargs="*", default=[], help="cfg field overrides k=v")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--multi", action="store_true")
    args = ap.parse_args()
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)

    mesh = production_mesh(args.multi)
    mesh_name = "multi_pod_2x16x16" if args.multi else "single_pod_16x16"
    out_dir = os.path.join(os.path.dirname(ARTIFACT_DIR), "perf", args.tag)
    overrides = dict(parse_override(kv) for kv in args.set)

    if args.arch == "grf-gp":
        rec = run_gp_cell(mesh, mesh_name, out_dir,
                          compress=bool(overrides.get("compress", False)),
                          compact=bool(overrides.get("compact", False)))
    else:
        cfg = dataclasses.replace(get_config(args.arch), **overrides)
        rec = run_cell(args.arch, args.shape, mesh, mesh_name, out_dir,
                       cfg_override=cfg)
    if rec["status"] == "ok":
        r = rec["roofline"]
        print(json.dumps({
            "tag": args.tag, "arch": args.arch, "shape": args.shape,
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"], "dominant": r["dominant"],
            "flops_per_device": r["flops_per_device"],
            "trace_seconds": rec["trace_seconds"],
        }, indent=1))
    else:
        print("ERROR:", rec["error"])


if __name__ == "__main__":
    main()
