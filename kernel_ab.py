#!/usr/bin/env python3
"""Time the fused K̂ and cross-Gram kernels of this checkout against those of
another checkout of the repository, on one CUDA card, with the same inputs.

    python3 kernel_ab.py --other PATH [--rounds 2]

PATH is the root of the other checkout (for example the parent commit,
unpacked with ``git archive``).  Each side runs in its own process, which
imports ``repro_torch`` from that side's ``src/``, builds its two kernels
and times them at the main-path shapes; the sides alternate other, this,
this, other (``--rounds`` pairs), so that a drift of the card's clocks
falls on both.  Inputs are walk payloads of ring(10⁶, k=3) drawn by the
port's walk sampler from fixed seeds, identical on both sides:

  gram_block  chip_smoke.py's serving shapes (K = 144, capacity 128), the
              Thompson q×q Gram and the Nyström pivot column [4000, 144] ×
              [1, 144] of the solvers' clustered block;
  khat_fused  the posterior's CG shape [1024, 48], R = 16 (f32 and bf16),
              the solvers' CG shape [4000, 144], R = 1, and the cross form
              [10⁶, 48] × [1024, 48], R = 16.

Each time is the device time per call of CUDA-graph replays (``graph``) and
of an eager loop timed with CUDA events (``eager``, which a host slower than
the kernel bounds).  A side whose wrapper takes a column index gets the one
its walk trace keeps, built once and timed apart (``index_ms``, host clock
ending in a synchronize).  Prints one JSON line per side and round, then a
table of medians.  Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N = 1_000_000
MAIN = dict(n_walkers=8, p_halt=0.2, l_max=5, n_train=1024, r=16)
WIDE = dict(n_walkers=16, p_halt=0.1, l_max=8, capacity=128, solve_rows=4000)
GRAM_ROWS = (1, 64, 128, 256, 512)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps: int) -> float | None:
    """Device ms per call over ``reps`` calls captured in one CUDA graph;
    None when the side's kernel cannot be captured."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError:
        torch.cuda.synchronize()
        return None
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def worker(src: str) -> dict:
    sys.path.insert(0, str(Path(src) / "src"))
    import torch

    from repro_torch.core import features, modulation, walks
    from repro_torch.graphs import generators
    from repro_torch.kernels import build
    from repro_torch.kernels.ell_spmv import ops as eops
    from repro_torch.kernels.gram_block import ops as gops

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.build_all(("khat_fused", "gram_block"))
    out = dict(src=src, build_s=time.perf_counter() - t0, gram={}, khat={})
    indexed = "index" in inspect.signature(eops.khat_fused_raw).parameters
    graph = generators.ring(N, k=3, device=dev)
    rng = np.random.default_rng(16)

    def rows(cfg, nodes, f):
        tr = walks.sample_walks_for_nodes(
            graph, torch.from_numpy(np.asarray(nodes, np.int32)).to(dev), 1214163296,
            cfg["n_walkers"], cfg["p_halt"], cfg["l_max"])
        return tr, features.feature_values(tr, f).contiguous(), tr.cols.contiguous()

    def timed(fn, reps):
        return dict(graph=graph_ms(fn, reps), eager=cuda_ms(fn, reps))

    # Cross-Gram: serving payloads and the Nyström column.
    mod = modulation.diffusion(l_max=WIDE["l_max"])
    f_wide = mod({"log_beta": torch.tensor(np.log(4.0), device=dev),
                  "log_sigma_f": torch.tensor(np.log(25.0), device=dev)})
    pay = {m: rows(WIDE, rng.choice(N, m, replace=False), f_wide)[1:]
           for m in GRAM_ROWS}
    shapes = [(m, WIDE["capacity"]) for m in GRAM_ROWS] + [(512, 512)]
    for m_r, m_c in shapes:
        (vr, cr), (vc, cc) = pay[m_r], pay[m_c]
        out["gram"][f"{m_r}x{m_c}"] = timed(
            lambda: gops.gram_block_raw(vr, cr, vc, cc), 50)
    tr_s, vs, cs = rows(WIDE, np.arange(WIDE["solve_rows"]), f_wide)
    piv_v, piv_c = vs[2000:2001].contiguous(), cs[2000:2001].contiguous()
    out["gram"]["4000x1"] = timed(
        lambda: gops.gram_block_raw(vs, cs, piv_v, piv_c), 100)

    # Fused K̂: the CG shapes and the cross form.
    mod = modulation.diffusion(l_max=MAIN["l_max"])
    f_main = mod(mod.init(device=dev))
    train = np.sort(np.random.default_rng(0).choice(N, MAIN["n_train"], replace=False))
    tr_x, vx, cx = rows(MAIN, train, f_main)
    gen = torch.Generator(device=dev).manual_seed(3)
    alpha = torch.randn((MAIN["n_train"], MAIN["r"]), generator=gen, device=dev)
    p1 = torch.randn((WIDE["solve_rows"],), generator=gen, device=dev)

    def index_of(tr):
        if not indexed:
            return {}
        from repro_torch.kernels.ell_spmv.index import column_index

        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            column_index(tr.cols, tr.loads, N)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        idx = tr.column_index(N)
        return dict(index=idx, index_ms=float(np.median(walls)), n_uniq=idx.n_uniq)

    def khat(name, v_r, c_r, v_c, c_c, v, tr_c, reps):
        extra = index_of(tr_c)
        kw = {"index": extra.pop("index")} if extra else {}
        out["khat"][name] = dict(timed(
            lambda: eops.khat_fused_raw(v_r, c_r, v_c, c_c, v, N, **kw), reps), **extra)

    khat("posterior CG f32", vx, cx, vx, cx, alpha, tr_x, 100)
    vb = vx.to(torch.bfloat16)
    khat("posterior CG bf16", vb, cx, vb, cx, alpha, tr_x, 100)
    khat("solvers CG", vs, cs, vs, cs, p1, tr_s, 100)
    full = walks.sample_walks(graph, 1214163296, MAIN["n_walkers"], MAIN["p_halt"],
                              MAIN["l_max"])
    vf = features.feature_values(full, f_main).contiguous()
    khat("cross", vf, full.cols, vx, cx, alpha, tr_x, 20)
    out["device"] = torch.cuda.get_device_name(0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("kernel_ab: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    if not args.other:
        ap.error("--other is required")
    other = str(Path(args.other).resolve())
    runs = {"other": [], "this": []}
    for side in ["other", "this", "this", "other"] * args.rounds:
        src = other if side == "other" else str(ROOT)
        res = subprocess.run([sys.executable, __file__, "--worker", src],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        line = res.stdout.strip().splitlines()[-1]
        print(f"[{side}] {line}")
        runs[side].append(json.loads(line))
    print(f"kernel_ab: device {runs['this'][0]['device']}; median ms per call "
          "(graph replay / eager loop), other → this")
    for kind in ("gram", "khat"):
        for shape in runs["this"][0][kind]:
            cell = {}
            for side in ("other", "this"):
                for how in ("graph", "eager"):
                    xs = [r[kind][shape][how] for r in runs[side]
                          if r[kind][shape][how] is not None]
                    cell[side, how] = float(np.median(xs)) if xs else None
            fmt = lambda x: "n/a" if x is None else f"{x:.5f}"   # noqa: E731
            extra = runs["this"][0][kind][shape]
            idx = (f"; index build {extra['index_ms']:.3f} ms, U {extra['n_uniq']}"
                   if "index_ms" in extra else "")
            print(f"[ab] {kind} {shape}: graph {fmt(cell['other', 'graph'])} → "
                  f"{fmt(cell['this', 'graph'])}, eager {fmt(cell['other', 'eager'])} → "
                  f"{fmt(cell['this', 'eager'])}{idx}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
