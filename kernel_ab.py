#!/usr/bin/env python3
"""Time the walk sampler, ELL gather, fused K̂, cross-Gram and Woodbury
kernels of this checkout against those of another checkout of the
repository, on one CUDA card, with the same inputs.

    python3 kernel_ab.py --other PATH [--rounds 2] [--kernels a,b,...]

PATH is the root of the other checkout (for example the parent commit,
unpacked with ``git archive``).  Each side runs in its own process, which
imports ``repro_torch`` from that side's ``src/``, builds its kernels and
times them at the main-path shapes; the sides alternate other, this, this,
other (``--rounds`` pairs), so that a drift of the card's clocks falls on
both.  ``--kernels`` picks among walk_sampler, ell_spmv, woodbury_apply,
gram_block and khat_fused (default: all).  Inputs are ring(10⁶, k=3) and walk payloads
of it drawn by the port's walk sampler from fixed seeds, identical on both
sides:

  walk_sampler    the monolithic trace (10⁶ rows, 8 walkers, l_max 5:
                  K = 48), one chunk of the chunked paths (65536 rows,
                  K = 48) and the wide trace (10⁶ rows, 16 walkers, l_max 8:
                  K = 144); the bound counts the outputs and the adjacency
                  rows of the nodes the walks visit;
  ell_spmv        y = Φu with u [10⁶, 16] at the prior draw over the
                  monolithic trace [10⁶, 48], one chunk of the chunked
                  products [65536, 48] and one at the serving and solvers
                  width [65536, 144] (16 walkers, l_max 8), which also runs
                  with a 1-D u; the bound counts the payload, the rows of u
                  that the non-zero slots touch and y;
  woodbury_apply  T = 4000 × r in {64, 128, 256} × R in {1, 9, 16} on the
                  Nyström operands of chip_smoke.py's solvers block (K = 144,
                  β = 4, σ_f = 25, σ² = 1e-2); every time is also taken as
                  profiled device time (``prof``);
  gram_block      chip_smoke.py's serving shapes (K = 144, capacity 128),
                  the Thompson q×q Gram and the Nyström pivot column
                  [4000, 144] × [1, 144] of the solvers' clustered block;
  khat_fused      the posterior's CG shape [1024, 48], R = 16 (f32 and
                  bf16), the solvers' CG shape [4000, 144], R = 1, and the
                  cross form [10⁶, 48] × [1024, 48], R = 16.

Each time is the device time per call of CUDA-graph replays (``graph``; n/a
where a side's launch cannot be captured) and of an eager loop timed with
CUDA events (``eager``, which a host slower than the kernel bounds).  A
side whose wrapper takes a column index gets the one its walk trace keeps,
built once and timed apart (``index_ms``, host clock ending in a
synchronize).  Prints one JSON line per side and round, then a
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
KERNELS = ("walk_sampler", "ell_spmv", "woodbury_apply", "gram_block", "khat_fused")
# walk_sampler's shapes: (label, rows, walker config, graph-replay and eager
# repetitions).  A replayed graph keeps every call's outputs, so the wide
# trace (1.7 GB a call) replays few.
WALK_SHAPES = (("1000000x48", N, MAIN, 5, 10), ("65536x48", 65536, MAIN, 40, 40),
               ("1000000x144", N, WIDE, 3, 5))
SPMV_CHUNK = 65536   # core/walks.py DEFAULT_CHUNK: one chunk of the chunked products
WOOD_RANKS = (64, 128, 256)
WOOD_COLS = (1, 9, 16)
SOLVE = dict(beta=4.0, sigma_f=25.0, sigma_n2=1e-2)
HBM_BYTES_PER_S = 3.35e12


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


def prof_ms(fn, reps: int) -> float | None:
    """Device ms per call from torch.profiler: the device time of every
    kernel, memset and copy of ``reps`` calls, over ``reps``; None when the
    profiler sees no device time."""
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    us = sum(e.device_time_total for e in pr.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps if us else None


def timed(fn, reps, eager_reps=None, prof=False) -> dict:
    out = dict(graph=graph_ms(fn, reps), eager=cuda_ms(fn, eager_reps or reps))
    if prof:
        out["prof"] = prof_ms(fn, reps)
    return out


def walk_cases(dev, graph, out: dict) -> None:
    """walk_sampler at WALK_SHAPES, with the bound of this run's inputs."""
    import torch

    from repro_torch.kernels.walk_sampler import ops as wops

    nbytes_adj = graph.neighbors.shape[1] * 8 + 4   # a visited node's row and degree
    for label, rows, cfg, reps, eager_reps in WALK_SHAPES:
        nodes = torch.arange(rows, dtype=torch.int32, device=dev)
        kw = dict(n_walkers=cfg["n_walkers"], p_halt=cfg["p_halt"], l_max=cfg["l_max"])
        args = (graph.neighbors, graph.weights, graph.deg, nodes, 1214163296)
        cols = wops.walk_sample(*args, **kw)[0]
        seen = torch.zeros(N, dtype=torch.bool, device=dev)
        seen[cols.reshape(-1).long()] = True
        visited = int(seen.sum())
        del cols, seen
        k = cfg["n_walkers"] * (cfg["l_max"] + 1)
        nbytes = 3 * rows * k * 4 + rows * 4 + visited * nbytes_adj
        out["walk_sampler"][label] = dict(
            timed(lambda: wops.walk_sample(*args, **kw), reps, eager_reps),
            visited=visited, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        torch.cuda.empty_cache()


def spmv_cases(dev, graph, out: dict) -> None:
    """ell_spmv at the paths' shapes, with the bound of these inputs."""
    import torch

    from repro_torch.core import features, modulation, walks
    from repro_torch.kernels.ell_spmv import ops as eops

    mod = modulation.diffusion(l_max=MAIN["l_max"])
    full = walks.sample_walks(graph, 1214163296, MAIN["n_walkers"], MAIN["p_halt"],
                              MAIN["l_max"])
    vf = features.feature_values(full, mod(mod.init(device=dev))).contiguous()
    cf = full.cols
    del full
    mod = modulation.diffusion(l_max=WIDE["l_max"])
    f_wide = mod({"log_beta": torch.tensor(np.log(SOLVE["beta"]), device=dev),
                  "log_sigma_f": torch.tensor(np.log(SOLVE["sigma_f"]), device=dev)})
    chunk = torch.arange(SPMV_CHUNK, dtype=torch.int32, device=dev)
    wide = walks.sample_walks_for_nodes(graph, chunk, 1214163296, WIDE["n_walkers"],
                                        WIDE["p_halt"], WIDE["l_max"])
    gen = torch.Generator(device=dev).manual_seed(3)
    u = torch.randn((N, MAIN["r"]), generator=gen, device=dev)
    vw = features.feature_values(wide, f_wide).contiguous()
    cases = [(vf, cf, u, 20), (vf[:SPMV_CHUNK], cf[:SPMV_CHUNK], u, 100),
             (vw, wide.cols, u, 100), (vw, wide.cols, u[:, 0].contiguous(), 100)]
    for vals, cols, v, reps in cases:
        live = vals != 0
        seen = torch.zeros(N, dtype=torch.bool, device=dev)
        seen[cols[live].long()] = True
        (m, k), r = vals.shape, 1 if v.dim() == 1 else v.shape[1]
        nbytes = m * k * 8 + int(seen.sum()) * r * 4 + m * r * 4
        del live, seen
        out["ell_spmv"][f"{m}x{k}x{r}"] = dict(
            timed(lambda: eops.ell_spmv_raw(vals, cols, v), reps),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        torch.cuda.empty_cache()


def woodbury_cases(dev, graph, out: dict) -> None:
    """woodbury_apply at T = 4000 × WOOD_RANKS × WOOD_COLS on the solvers
    block's Nyström operands."""
    import math

    import torch

    from repro_torch import solvers
    from repro_torch.core import linops, modulation, walks
    from repro_torch.kernels.woodbury_apply import ops as wops

    t = WIDE["solve_rows"]
    f = modulation.diffusion(l_max=WIDE["l_max"])({
        "log_beta": torch.tensor(math.log(SOLVE["beta"]), device=dev),
        "log_sigma_f": torch.tensor(math.log(SOLVE["sigma_f"]), device=dev)})
    train = torch.arange(t, dtype=torch.int32, device=dev)
    tr = walks.sample_walks_for_nodes(graph, train, 1214163296, WIDE["n_walkers"],
                                      WIDE["p_halt"], WIDE["l_max"])
    h = linops.shifted(tr, f, SOLVE["sigma_n2"], N)
    gen = torch.Generator(device=dev).manual_seed(6)
    for r in WOOD_RANKS:
        pc = solvers.nystrom_precond(h, rank=r)
        b, dinv, einv = pc._b, pc._dinv, pc._einv
        for cols in WOOD_COLS:
            v = torch.randn((t,) if cols == 1 else (t, cols), generator=gen, device=dev)
            out["woodbury_apply"][f"{t}x{r}x{cols}"] = timed(
                lambda: wops.woodbury_apply_raw(b, dinv, einv, v), 200, prof=True)


def worker(src: str, kernels: list[str]) -> dict:
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
    build.build_all(tuple(x for x in build.SOURCES
                          if x not in ("flash_attention", "rmsnorm")))
    out = dict(src=src, build_s=time.perf_counter() - t0,
               **{k: {} for k in kernels})
    graph = generators.ring(N, k=3, device=dev)
    if "walk_sampler" in kernels:
        walk_cases(dev, graph, out)
    if "ell_spmv" in kernels:
        spmv_cases(dev, graph, out)
    if "woodbury_apply" in kernels:
        woodbury_cases(dev, graph, out)
    out["device"] = torch.cuda.get_device_name(0)
    if "gram_block" not in kernels and "khat_fused" not in kernels:
        return out
    indexed = "index" in inspect.signature(eops.khat_fused_raw).parameters
    rng = np.random.default_rng(16)

    def rows(cfg, nodes, f):
        tr = walks.sample_walks_for_nodes(
            graph, torch.from_numpy(np.asarray(nodes, np.int32)).to(dev), 1214163296,
            cfg["n_walkers"], cfg["p_halt"], cfg["l_max"])
        return tr, features.feature_values(tr, f).contiguous(), tr.cols.contiguous()

    # Cross-Gram: serving payloads and the Nyström column.
    mod = modulation.diffusion(l_max=WIDE["l_max"])
    f_wide = mod({"log_beta": torch.tensor(np.log(4.0), device=dev),
                  "log_sigma_f": torch.tensor(np.log(25.0), device=dev)})
    tr_s, vs, cs = rows(WIDE, np.arange(WIDE["solve_rows"]), f_wide)
    if "gram_block" in kernels:
        pay = {m: rows(WIDE, rng.choice(N, m, replace=False), f_wide)[1:]
               for m in GRAM_ROWS}
        shapes = [(m, WIDE["capacity"]) for m in GRAM_ROWS] + [(512, 512)]
        for m_r, m_c in shapes:
            (vr, cr), (vc, cc) = pay[m_r], pay[m_c]
            out["gram_block"][f"{m_r}x{m_c}"] = timed(
                lambda: gops.gram_block_raw(vr, cr, vc, cc), 50)
        piv_v, piv_c = vs[2000:2001].contiguous(), cs[2000:2001].contiguous()
        out["gram_block"]["4000x1"] = timed(
            lambda: gops.gram_block_raw(vs, cs, piv_v, piv_c), 100)
    if "khat_fused" not in kernels:
        return out

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
        out["khat_fused"][name] = dict(timed(
            lambda: eops.khat_fused_raw(v_r, c_r, v_c, c_c, v, N, **kw), reps), **extra)

    khat("posterior CG f32", vx, cx, vx, cx, alpha, tr_x, 100)
    vb = vx.to(torch.bfloat16)
    khat("posterior CG bf16", vb, cx, vb, cx, alpha, tr_x, 100)
    khat("solvers CG", vs, cs, vs, cs, p1, tr_s, 100)
    full = walks.sample_walks(graph, 1214163296, MAIN["n_walkers"], MAIN["p_halt"],
                              MAIN["l_max"])
    vf = features.feature_values(full, f_main).contiguous()
    khat("cross", vf, full.cols, vx, cx, alpha, tr_x, 20)
    return out


def _median(runs: list, kind: str, shape: str, how: str):
    xs = []
    for r in runs:
        cell = r[kind].get(shape, {})
        if cell.get(how) is not None:
            xs.append(cell[how])
    return float(np.median(xs)) if xs else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ", ".join(KERNELS))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    kernels = [k for k in args.kernels.split(",") if k]
    bad = sorted(set(kernels) - set(KERNELS))
    if bad:
        ap.error(f"unknown kernels {bad}; valid: {', '.join(KERNELS)}")
    try:
        import torch
    except ImportError:
        print("kernel_ab: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        print(json.dumps(worker(args.worker, kernels)))
        return 0
    if not args.other:
        ap.error("--other is required")
    other = str(Path(args.other).resolve())
    runs = {"other": [], "this": []}
    for side in ["other", "this", "this", "other"] * args.rounds:
        src = other if side == "other" else str(ROOT)
        res = subprocess.run([sys.executable, __file__, "--worker", src,
                              "--kernels", ",".join(kernels)],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        line = res.stdout.strip().splitlines()[-1]
        print(f"[{side}] {line}")
        runs[side].append(json.loads(line))
    print(f"kernel_ab: device {runs['this'][0]['device']}; median ms per call, "
          "other → this")
    fmt = lambda x: "n/a" if x is None else f"{x:.5f}"   # noqa: E731
    for kind in kernels:
        for shape, extra in runs["this"][0][kind].items():
            hows = ("graph", "eager", "prof") if "prof" in extra else ("graph", "eager")
            line = ", ".join(
                f"{how} {fmt(_median(runs['other'], kind, shape, how))} → "
                f"{fmt(_median(runs['this'], kind, shape, how))}" for how in hows)
            if "index_ms" in extra:
                line += f"; index build {extra['index_ms']:.3f} ms, U {extra['n_uniq']}"
            if "visited" in extra:
                line += (f"; bound {extra['bound_ms']:.5f} ms, {extra['visited']} "
                         "nodes visited")
            elif "bound_ms" in extra:
                line += f"; bound {extra['bound_ms']:.5f} ms"
            print(f"[ab] {kind} {shape}: {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
