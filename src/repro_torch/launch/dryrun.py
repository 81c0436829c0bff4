"""Multi-pod dry run (port of ``repro/launch/dryrun.py``).

For every (architecture × input shape) cell and both production meshes
(single-pod 16×16, multi-pod 2×16×16), this:
  1. starts a fake process group of 256 or 512 ranks in this one process
     (``torch.testing``'s ``FakeStore`` and the ``fake`` backend: its
     collectives move nothing) and the production ``DeviceMesh`` over it;
  2. builds the step and its inputs as DTensors whose shards live on
     ``meta`` (``specs.py``: no allocation);
  3. traces one train step, prefill or decode step as rank 0 and records
     the per-device FLOPs, bytes, collectives and memory that
     ``hlo_analysis.summarize`` counts, with the H100 roofline terms, to
     ``build/repro_torch/dryrun/<mesh>/<arch>__<shape>.json``.

A trace that runs proves the cell's placements coherent: every op has a
sharding (DTensor's or a shard-local region), every shape divides.  Tracing
is eager, so every repeat, KV chunk and SSD chunk is counted as it runs:
JAX's trip-count probes (``_corrected_summary``) have no counterpart, and a
record says so (``"probes": []`` and ``"counting"``).  Attention is counted
through its plain version (``mha_ref``, or ``mha_chunked_ref`` when
``cfg.attn_impl`` is "chunked"), as JAX's dry run traces ``attn_impl``,
not the kernel; the record names it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch gemma3-4b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both     # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --gp            # GRF-GP cells
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
import traceback

from ..configs import get_config, list_archs
from ..models.config import SHAPES
from . import hlo_analysis, specs
from . import sharding as shr
from .mesh import make_production_mesh

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "repro_torch", "dryrun")
MESHES = {"single_pod_16x16": False, "multi_pod_2x16x16": True}
COUNTING = ("eager trace of one step as rank 0 of a fake process group: "
            "every repeat and chunk counted as it runs, no trip-count probes; "
            "flops are matmul/attention FLOPs only")


def production_mesh(multi_pod: bool):
    """The production mesh over a fake process group of its size, started
    here (any earlier default group is destroyed first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 512 if multi_pod else 256
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def cell_list(arch_filter=None, shape_filter=None):
    cells = []
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in SHAPES:
            if shape == "long_500k" and not cfg.subquadratic:
                continue  # documented skip (DESIGN.md §4)
            if arch_filter and arch != arch_filter:
                continue
            if shape_filter and shape != shape_filter:
                continue
            cells.append((arch, shape))
    return cells


def _write(record: dict, out_dir: str, name: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=1, default=str)
    return record


def _failed(record: dict, e: Exception) -> None:
    record["status"] = "error"
    record["error"] = f"{type(e).__name__}: {e}"
    record["traceback"] = traceback.format_exc()[-2000:]


def run_cell(arch: str, shape: str, mesh, mesh_name: str, out_dir: str,
             cfg_override=None) -> dict:
    t0 = time.time()
    record = {"arch": arch, "shape": shape, "mesh": mesh_name,
              "mesh_shape": shr.axis_sizes(mesh)}
    try:
        cfg = cfg_override or get_config(arch)
        fn, args = specs.build_cell(cfg, shape, mesh)
        shr.set_activation_mesh(mesh)
        try:
            record.update(hlo_analysis.summarize(fn, args))
        finally:
            shr.set_activation_mesh(None)
        record["probes"] = []
        record["counting"] = COUNTING
        record["attention"] = ("mha_chunked_ref" if cfg.attn_impl == "chunked"
                               else "mha_ref")
        record["param_count"] = cfg.param_count()
        record["active_param_count"] = cfg.active_param_count()
        record["seq_len"] = SHAPES[shape]["seq_len"]
        record["global_batch"] = SHAPES[shape]["global_batch"]
        record["kind"] = SHAPES[shape]["kind"]
        record["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record, don't abort the matrix
        _failed(record, e)
    record["trace_seconds"] = round(time.time() - t0, 1)
    return _write(record, out_dir, f"{arch}__{shape}.json")


def run_gp_cell(mesh, mesh_name: str, out_dir: str, compress: bool = False,
                compact: bool = False) -> dict:
    t0 = time.time()
    record = {"arch": "grf-gp", "shape": "cg_1m", "mesh": mesh_name,
              "mesh_shape": shr.axis_sizes(mesh), "compress": compress,
              "compact": compact}
    try:
        fn, args = specs.build_gp_cell(mesh, compress=compress, compact=compact)
        record.update(hlo_analysis.summarize(fn, args))
        record["probes"] = []
        record["counting"] = COUNTING
        record["status"] = "ok"
    except Exception as e:  # noqa: BLE001
        _failed(record, e)
    record["trace_seconds"] = round(time.time() - t0, 1)
    suffix = "".join(s for s, on in (("_compact", compact), ("_compress", compress)) if on)
    return _write(record, out_dir, f"grf-gp__cg_1m{suffix}.json")


def describe(rec: dict) -> str:
    """One line for a record: status, trace time and the roofline."""
    if rec["status"] != "ok":
        return f"ERROR ({rec['trace_seconds']}s) {rec['error'][:160]}"
    r, m = rec["roofline"], rec["memory"]
    return (f"ok ({rec['trace_seconds']}s) flops/dev={r['flops_per_device']:.4e} "
            f"bytes/dev={r['bytes_per_device']:.4e} wire/dev={r['wire_bytes_per_device']:.4e} "
            f"arg={m['argument_bytes']} temp={m['temp_bytes']} "
            f"compute={r['compute_s']:.4g}s memory={r['memory_s']:.4g}s "
            f"collective={r['collective_s']:.4g}s dominant={r['dominant']}")


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--gp", action="store_true",
                    help="run the GRF-GP cells (plain and compact) only")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args()
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)

    names = [n for n, multi in MESHES.items()
             if args.mesh == "both" or (args.mesh == "multi") == multi]
    for mesh_name in names:
        mesh = production_mesh(MESHES[mesh_name])
        out_dir = os.path.join(args.out, mesh_name)
        t0 = time.time()
        if args.gp:
            for compact in (False, True):
                rec = run_gp_cell(mesh, mesh_name, out_dir, compact=compact)
                print(f"[{mesh_name}] grf-gp/cg_1m{' compact' if compact else ''}: "
                      f"{describe(rec)}", flush=True)
            continue
        for arch, shape in cell_list(args.arch, args.shape):
            rec = run_cell(arch, shape, mesh, mesh_name, out_dir)
            print(f"[{mesh_name}] {arch}/{shape}: {describe(rec)}", flush=True)
        print(f"[{mesh_name}] matrix traced in {time.time() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
