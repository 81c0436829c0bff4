#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) end to end on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (the first failure ends the run with a
non-zero exit and no result line):

  1. device    card name, `nvidia-smi` name and power limit; build the four
               CUDA kernels (one nvcc per source, in parallel) and print
               their `-Xptxas -v` registers / spills.
  2. parity    each kernel against its plain PyTorch version on the card at
               ragged shapes (1-D and R in {3, 16}, duplicate columns, zero
               slots, every walk scheme, an isolated node, bf16 K̂ payloads),
               plus the walk golden checksums of the JAX reference.
  3. main path ring(10⁶, k=3), 8 walkers, p_halt 0.2, l_max 5 (K = 48),
               T = 1024 observations, 16 samples: posterior_mean,
               pathwise_samples on the monolithic trace and
               pathwise_samples_chunked (chunk 65536).  Launch counts are set
               to 0 just before and read just after; every kernel must have
               launched, CG must converge, chunked must equal monolithic.
               Then each call again, warm (median of 3), and one
               torch.profiler pass for each call's device busy time, whose
               share of the warm wall time is the card's busy share.
  4. e2e       the same path at ring(20000) on the card and on the CPU (plain
               versions), compared.
  5. timing    each kernel at the main-path shapes with CUDA events: kernel,
               plain version, library call where one exists, and the bound;
               printed as one {"kernels": [...]} line.

The last line is {"ok": true, "device": {...}}.  Without a CUDA card, or
without the repository beside this file, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
import warnings
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM float32, outside the tensor cores

# Tolerances, each relative to the largest |value| of the plain result:
#   walk cols/lens are integer results of the same hash — compared exactly;
#   walk loads repeat the plain version's float32 multiplications in the same
#   order — compared exactly as well (max_abs_err reported);
#   gather sums run over K slots in another order (and with FMA) than
#   PyTorch's einsum: 1e-5;
#   scatter and fused K̂ add with float atomics in a run-dependent order: 1e-5
#   (f32) and 1e-5 for bf16 payloads too, since both sides upcast the same
#   bf16 values exactly and accumulate in f32;
#   end-to-end results pass through CG (tol 1e-5 on the relative residual),
#   whose iterates amplify those rounding differences; chunked vs monolithic
#   and card vs CPU are held to 1e-4.
KERNEL_RTOL = 1e-5
E2E_RTOL = 1e-4

GOLDEN = dict(seed=1214163296, cols_crc=1350745773, lens_crc=1932814751,
              loads_sum=144.53968, loads_tol=1e-4)

MAIN = dict(n_nodes=1_000_000, ring_k=3, n_walkers=8, p_halt=0.2, l_max=5,
            n_train=1024, sigma_n2=0.05, n_samples=16, chunk=65536)
E2E = dict(MAIN, n_nodes=20_000, n_train=256, chunk=4096)

REPLACES = {
    "walk_sampler": "src/repro/kernels/walk_sampler/walk_sampler.py:59",
    "ell_spmv": "src/repro/kernels/ell_spmv/ell_spmv.py:42",
    "ell_spmv_t": "src/repro/kernels/ell_spmv/ell_spmv_t.py:48",
    "khat_fused": "src/repro/kernels/ell_spmv/khat_fused.py:83",
}


class PhaseError(RuntimeError):
    pass


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def rel_err(got, want) -> tuple[float, float]:
    """(max |got − want|, that divided by max |want|)."""
    import torch

    err = float(torch.max(torch.abs(got.double() - want.double())).item()) \
        if got.numel() else 0.0
    scale = float(torch.max(torch.abs(want.double())).item()) if want.numel() else 0.0
    return err, err / max(scale, 1e-30)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# --------------------------------------------------------------------------
# Phase 1: device and build
# --------------------------------------------------------------------------


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_device(dev) -> str:
    import torch

    from repro_torch.kernels import build

    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"card {torch.cuda.get_device_name(dev)} "
          f"count {torch.cuda.device_count()}")
    smi = nvidia_smi_line()
    print(f"[device] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] four kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for name, lines in build.ptxas_report().items():
        for ln in lines.splitlines():
            print(f"[ptxas] {name}: {ln.strip()}")
    return smi


# --------------------------------------------------------------------------
# Phase 2: kernel vs plain version at ragged shapes
# --------------------------------------------------------------------------


def _payload(rng, m, k, n, dup: bool, zero_frac: float):
    vals = rng.standard_normal((m, k)).astype(np.float32)
    vals[rng.random((m, k)) < zero_frac] = 0.0
    hi = max(2, n // 50) if dup else n       # few distinct columns ⇒ duplicates
    cols = rng.integers(0, hi, (m, k)).astype(np.int32)
    return vals, cols


def check_kernel_cases(dev) -> None:
    """ell_spmv / ell_spmv_t / khat_fused against their plain versions."""
    import torch

    from repro_torch.kernels.ell_spmv import ops, ref

    rng = np.random.default_rng(11)
    t = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
    cases = 0
    for (m, k, n) in [(1037, 48, 5003), (1, 7, 9), (2561, 13, 700)]:
        for r in (None, 3, 16):
            for dup in (False, True):
                vals, cols = _payload(rng, m, k, n, dup, 0.3)
                u = rng.standard_normal((n,) if r is None else (n, r)).astype(np.float32)
                v = rng.standard_normal((m,) if r is None else (m, r)).astype(np.float32)
                got = ops.ell_spmv(t(vals), t(cols), t(u))
                _, rel = rel_err(got, ref.ell_spmv_ref(t(vals), t(cols), t(u)))
                expect(rel <= KERNEL_RTOL, f"ell_spmv m={m} k={k} r={r}: rel {rel:.2e}")
                got = ops.ell_spmv_t(t(vals), t(cols), t(v), n)
                _, rel = rel_err(got, ref.ell_spmv_t_ref(t(vals), t(cols), t(v), n))
                expect(rel <= KERNEL_RTOL, f"ell_spmv_t m={m} k={k} r={r}: rel {rel:.2e}")
                cases += 2
                # Rectangular K̂[rows, cols] with a different row payload.
                vr, cr = _payload(rng, m + 333, k + 2, n, dup, 0.2)
                for dt in (torch.float32, torch.bfloat16):
                    a, b = t(vr).to(dt), t(vals).to(dt)
                    got = ops.khat_fused(a, t(cr), b, t(cols), t(v), n)
                    want = ref.khat_matvec_ref(a, t(cr), b, t(cols), t(v), n)
                    _, rel = rel_err(got, want)
                    expect(rel <= KERNEL_RTOL,
                           f"khat_fused rect m={m} r={r} {dt}: rel {rel:.2e}")
                    got = ops.khat_fused(b, t(cols), b, t(cols), t(v), n)
                    want = ref.khat_matvec_ref(b, t(cols), b, t(cols), t(v), n)
                    _, rel = rel_err(got, want)
                    expect(rel <= KERNEL_RTOL,
                           f"khat_fused square m={m} r={r} {dt}: rel {rel:.2e}")
                    cases += 2
    print("[parity] ell_spmv, ell_spmv_t, khat_fused (f32 + bf16) match their "
          f"plain versions within {KERNEL_RTOL:g} of scale in {cases} ragged cases")


def check_walk_cases(dev) -> None:
    """Walk kernel vs plain for every scheme, with an isolated node, plus the
    JAX golden checksums."""
    import torch

    from repro_torch.graphs import formats, generators
    from repro_torch.kernels.walk_sampler import ops, ref, rng

    # ring of 1000 plus node 1000 with no edges (degree 0).
    idx = np.arange(1000)
    edges = np.concatenate([np.stack([idx, (idx + o) % 1000], 1) for o in (1, 2, 5)])
    g = formats.from_edges(edges, 1001, device=dev)
    expect(int(g.deg[1000]) == 0, "isolated node has a degree")
    gen = np.random.default_rng(5)
    nodes = torch.from_numpy(
        np.concatenate([[1000], gen.choice(1000, 776, replace=False)]).astype(np.int32)
    ).to(dev)   # M = 777, not a multiple of the block
    for scheme in rng.SCHEMES:
        for (w, p, l_max, reweight) in [(8, 0.2, 5, True), (5, 0.5, 3, False),
                                        (3, 0.1, 11, True)]:
            kw = dict(n_walkers=w, p_halt=p, l_max=l_max, reweight=reweight,
                      scheme=scheme)
            got = ops.walk_sample(g.neighbors, g.weights, g.deg, nodes, 987654321, **kw)
            want = ref.walk_sample_ref(g.neighbors, g.weights, g.deg, nodes, 987654321, **kw)
            expect(torch.equal(got[0], want[0]), f"walk cols differ ({scheme}, {kw})")
            expect(torch.equal(got[2], want[2]), f"walk lens differ ({scheme}, {kw})")
            err, _ = rel_err(got[1], want[1])
            expect(err == 0.0, f"walk loads differ by {err:.3e} ({scheme}, {kw})")
            # The isolated start node deposits only at step 0.
            expect(bool(torch.all(got[1][0].reshape(w, l_max + 1)[:, 1:] == 0)),
                   "isolated node deposits beyond step 0")
    g36 = generators.grid2d(6, 6, device=dev)
    nodes36 = torch.arange(36, dtype=torch.int32, device=dev)
    cols, loads, lens = ops.walk_sample(
        g36.neighbors, g36.weights, g36.deg, nodes36, GOLDEN["seed"],
        n_walkers=5, p_halt=0.2, l_max=3, scheme="iid")
    c_crc = zlib.crc32(cols.cpu().numpy().tobytes())
    l_crc = zlib.crc32(lens.cpu().numpy().tobytes())
    s = float(loads.cpu().numpy().astype(np.float64).sum())
    expect(c_crc == GOLDEN["cols_crc"], f"golden cols crc {c_crc}")
    expect(l_crc == GOLDEN["lens_crc"], f"golden lens crc {l_crc}")
    expect(abs(s - GOLDEN["loads_sum"]) < GOLDEN["loads_tol"], f"golden loads sum {s}")
    print("[parity] walk_sampler: cols/lens/loads bit-equal to the plain version "
          "for 4 schemes x 3 configs (M=777, isolated node); JAX golden "
          f"cols crc {c_crc}, lens crc {l_crc}, loads sum {s:.5f}")


# --------------------------------------------------------------------------
# Phases 3 and 4: the main path
# --------------------------------------------------------------------------


def make_problem(cfg: dict, dev):
    """Graph, walk config, modulation f, training nodes and y from seeds."""
    import torch

    from repro_torch.core import modulation, walks
    from repro_torch.graphs import generators, signals
    from repro_torch.gp import mll

    n = cfg["n_nodes"]
    graph = generators.ring(n, k=cfg["ring_k"], device=dev)
    wcfg = walks.WalkConfig(cfg["n_walkers"], cfg["p_halt"], cfg["l_max"])
    mod = modulation.diffusion(l_max=cfg["l_max"])
    params = mll.init_hyperparams(mod, device=dev)
    f = mod(params["mod"])
    rng = np.random.default_rng(0)
    train = np.sort(rng.choice(n, cfg["n_train"], replace=False)).astype(np.int32)
    truth = signals.smooth_periodic_ring(n, seed=1)
    y = (truth[train] + 0.1 * rng.standard_normal(len(train))).astype(np.float32)
    return (graph, wcfg, f, torch.from_numpy(train).to(dev),
            torch.from_numpy(y).to(dev))


def path_calls(cfg: dict, dev, gen_device):
    """The main path as (label, zero-argument call) pairs, in order:
    sample_walks, posterior_mean and pathwise_samples on the monolithic
    trace, then pathwise_samples_chunked (which drops the trace first, so
    its peak memory is the chunked path's own)."""
    import torch

    from repro_torch.core import walks
    from repro_torch.gp import posterior

    graph, wcfg, f, train, y = make_problem(cfg, dev)
    seed = walks.walk_seed(torch.Generator(device=gen_device).manual_seed(7))
    s2 = cfg["sigma_n2"]
    state = {}

    def sample():
        state["trace"] = walks.sample_walks(graph, seed, wcfg.n_walkers,
                                            wcfg.p_halt, wcfg.l_max)
        return state["trace"]

    def mean():
        return posterior.posterior_mean(state["trace"], train, f, s2, y)

    def mono():
        return posterior.pathwise_samples(
            state["trace"], train, f, s2, y,
            torch.Generator(device=gen_device).manual_seed(3),
            n_samples=cfg["n_samples"], return_diagnostics=True)

    def chunked():
        state.pop("trace", None)
        return posterior.pathwise_samples_chunked(
            graph, train, f, s2, y,
            torch.Generator(device=gen_device).manual_seed(3), seed, wcfg,
            chunk=cfg["chunk"], n_samples=cfg["n_samples"],
            return_diagnostics=True)

    calls = [("sample_walks", sample), ("posterior_mean", mean),
             ("pathwise_samples", mono), ("pathwise_samples_chunked", chunked)]
    return seed, calls


def timed_call(fn, dev) -> tuple[object, float, int | None]:
    """(result, wall seconds ending in a synchronize, peak bytes)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    return out, wall, peak


def run_path(cfg: dict, dev, gen_device, timings: dict | None = None):
    """Run the main path once; returns its outputs, the walk seed and the
    calls (for warm repeats).  ``timings`` receives per-call wall time, peak
    memory and kernel launches."""
    from repro_torch.kernels import dispatch

    seed, calls = path_calls(cfg, dev, gen_device)
    outs = {}
    for label, fn in calls:
        before = dispatch.launch_counts()
        out, wall, peak = timed_call(fn, dev)
        # The trace stays only in the calls' own state, which the chunked
        # call drops: its peak memory is then the chunked path's own.
        outs[label] = None if label == "sample_walks" else out
        if timings is not None:
            after = dispatch.launch_counts()
            timings[label] = dict(s=wall, max_mem=peak, launches={
                k: after[k] - before[k] for k in after})
    return dict(mean=outs["posterior_mean"], mono=outs["pathwise_samples"],
                chunked=outs["pathwise_samples_chunked"], seed=seed,
                calls=calls)


def warm_times(calls, dev, reps: int = 3) -> dict[str, float]:
    """Median warm wall seconds per call over ``reps`` passes of the path."""
    walls: dict[str, list[float]] = {label: [] for label, _ in calls}
    for _ in range(reps):
        for label, fn in calls:
            walls[label].append(timed_call(fn, dev)[1])
    return {k: float(np.median(v)) for k, v in walls.items()}


def device_busy(calls, dev, labels, warm: dict[str, float]) -> None:
    """Profile one warm pass; print each call's device busy time (sum of
    CUDA kernel, memset and memcpy times on the device) and its five largest
    kernels.  The busy and idle shares divide that time by the call's
    unprofiled warm wall time ``warm[label]``: the profiler inflates the wall
    time of the call it traces, so a share of the profiled wall would
    understate how busy the card is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for label, fn in calls:
        if label not in labels:
            fn()
            continue
        sync(dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # per-cycle notice
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                sync(dev)
                wall = time.perf_counter() - t0
        per_name: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per_name[e.name] = per_name.get(e.name, 0.0) + e.device_time_total
        busy_ms = sum(per_name.values()) / 1e3
        if busy_ms == 0.0:
            print(f"[trace] {label}: the profiler saw no device time "
                  "(device busy share not measured)")
            continue
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
        share = busy_ms / (warm[label] * 1e3)
        print(f"[trace] {label}: device busy {busy_ms:.2f} ms of "
              f"{warm[label] * 1e3:.2f} ms warm wall ({100 * share:.1f}%), idle "
              f"share {100 * (1 - share):.1f}% (profiled wall "
              f"{wall * 1e3:.2f} ms); top: "
              + "; ".join(f"{n[:48]} {t / 1e3:.3f} ms" for n, t in top))


def check_path_outputs(out: dict, cfg: dict, label: str) -> None:
    import torch

    n, s = cfg["n_nodes"], cfg["n_samples"]
    mean = out["mean"]
    (mono, it_m, conv_m), (chk, it_c, conv_c) = out["mono"], out["chunked"]
    expect(tuple(mean.shape) == (n,), f"{label}: mean shape {tuple(mean.shape)}")
    expect(tuple(mono.shape) == (n, s) and tuple(chk.shape) == (n, s),
           f"{label}: sample shapes {tuple(mono.shape)} {tuple(chk.shape)}")
    for name, x in (("mean", mean), ("monolithic", mono), ("chunked", chk)):
        expect(bool(torch.isfinite(x).all()), f"{label}: non-finite {name}")
    expect(conv_m and conv_c, f"{label}: CG did not converge "
           f"(monolithic {it_m} iters {conv_m}, chunked {it_c} iters {conv_c})")
    err, rel = rel_err(chk, mono)
    expect(rel <= E2E_RTOL, f"{label}: chunked vs monolithic rel {rel:.2e}")
    print(f"[{label}] CG converged: monolithic {it_m} iters, chunked {it_c} iters; "
          f"chunked vs monolithic max abs {err:.3e} (rel {rel:.2e}); "
          f"mean range [{float(mean.min()):.3f}, {float(mean.max()):.3f}]")


def phase_main(dev) -> dict:
    from repro_torch.kernels import dispatch

    timings: dict = {}
    dispatch.reset_launch_counts()
    out = run_path(MAIN, dev, dev, timings)
    counts = dispatch.launch_counts()
    for name, c in counts.items():
        expect(c > 0, f"main path never launched {name}")
    check_path_outputs(out, MAIN, "main")
    warm = warm_times(out["calls"], dev)
    for label, t in timings.items():
        print(f"[main] {label}: first call {t['s'] * 1e3:.1f} ms, warm median "
              f"{warm[label] * 1e3:.1f} ms (of 3), max_memory_allocated "
              f"{t['max_mem'] / 2**20:.0f} MiB, launches {json.dumps(t['launches'])}")
    print(f"[main] launches over the main path: {json.dumps(counts)}")
    device_busy(out["calls"], dev, ("posterior_mean", "pathwise_samples",
                                    "pathwise_samples_chunked"), warm)
    return dict(counts=counts, out=out, timings=timings)


def phase_e2e(dev) -> None:
    import torch

    cpu = torch.device("cpu")
    gpu_out = run_path(E2E, dev, cpu)
    cpu_out = run_path(E2E, cpu, cpu)
    check_path_outputs(gpu_out, E2E, "e2e-card")
    check_path_outputs(cpu_out, E2E, "e2e-cpu")
    for key, idx in (("mean", None), ("mono", 0), ("chunked", 0)):
        a = gpu_out[key] if idx is None else gpu_out[key][idx]
        b = cpu_out[key] if idx is None else cpu_out[key][idx]
        err, rel = rel_err(a.cpu(), b)
        expect(rel <= E2E_RTOL, f"e2e {key}: card vs CPU rel {rel:.2e}")
        print(f"[e2e] {key}: card (kernels) vs CPU (plain) max abs {err:.3e} "
              f"(rel {rel:.2e})")


# --------------------------------------------------------------------------
# Phase 5: timing at the main-path shapes
# --------------------------------------------------------------------------


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def csr(vals, cols, n_cols: int, transpose: bool = False):
    """The ELL payload as a torch CSR matrix (the library yardstick only)."""
    import torch

    m, k = vals.shape
    rows = torch.arange(m, device=vals.device).repeat_interleave(k)
    idx = torch.stack([rows, cols.reshape(-1).long()])
    shape = (m, n_cols)
    if transpose:
        idx, shape = idx.flip(0), (n_cols, m)
    with warnings.catch_warnings():   # PyTorch's "sparse CSR is beta" notes
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(idx, vals.reshape(-1).float(), shape,
                                      check_invariants=False)
        return coo.coalesce().to_sparse_csr()


def phase_timing(dev, main: dict) -> list[dict]:
    import torch

    from repro_torch.core import features, walks
    from repro_torch.kernels.ell_spmv import ops as eops
    from repro_torch.kernels.ell_spmv import ref as eref
    from repro_torch.kernels.walk_sampler import ops as wops
    from repro_torch.kernels.walk_sampler import ref as wref

    graph, wcfg, f, train, y = make_problem(MAIN, dev)
    n, s, t = MAIN["n_nodes"], MAIN["n_samples"], MAIN["n_train"]
    seed = main["out"]["seed"]
    counts = main["counts"]
    nodes = torch.arange(n, dtype=torch.int32, device=dev)
    wkw = dict(n_walkers=wcfg.n_walkers, p_halt=wcfg.p_halt, l_max=wcfg.l_max)
    gargs = (graph.neighbors, graph.weights, graph.deg, nodes, seed)
    rows = []

    def row(name, ms, plain_ms, errs, b, library_ms):
        err, rel = errs
        rows.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=REPLACES[name], launches=counts[name], max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
            library_ms=library_ms))
        print(f"[timing] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b[0]:.4f} ms ({b[1]}), library "
              f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}, "
              f"max_abs_err {err:.3e} (rel {rel:.2e})")

    # 1. Walk sampling over all N rows (the monolithic trace).
    got = wops.walk_sample(*gargs, **wkw)
    want = wref.walk_sample_ref(*gargs, **wkw)
    expect(torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]),
           "walk_sampler: cols/lens differ at the main-path shape")
    werr = rel_err(got[1], want[1])
    expect(werr[0] == 0.0, f"walk_sampler: loads differ by {werr[0]:.3e}")
    del want
    k = wcfg.slots
    d = graph.max_deg
    wbytes = n * d * 8 + n * 4 + n * 4 + 3 * n * k * 4
    row("walk_sampler", cuda_ms(lambda: wops.walk_sample(*gargs, **wkw), 20),
        cuda_ms(lambda: wref.walk_sample_ref(*gargs, **wkw), 3), werr,
        bound(wbytes, n * wcfg.n_walkers * (wcfg.l_max + 1) * 6), None)

    trace = walks.WalkTrace(*got)
    del got
    vals = features.feature_values(trace, f).contiguous()
    cols = trace.cols
    tx = features.take_rows(trace, train)
    vals_x = features.feature_values(tx, f).contiguous()
    cols_x = tx.cols.contiguous()
    gen = torch.Generator(device=dev).manual_seed(3)
    w = torch.randn((n, s), generator=gen, device=dev)
    alpha = torch.randn((t, s), generator=gen, device=dev)
    nnz = int((vals != 0).sum())
    nnz_x = int((vals_x != 0).sum())

    # 2. Prior draw g = Φ w.
    a_csr = csr(vals, cols, n)
    got = eops.ell_spmv(vals, cols, w)
    err, rel = rel_err(got, eref.ell_spmv_ref(vals, cols, w))
    expect(rel <= KERNEL_RTOL, f"ell_spmv at the main-path shape: rel {rel:.2e}")
    row("ell_spmv", cuda_ms(lambda: eops.ell_spmv(vals, cols, w), 20),
        cuda_ms(lambda: eref.ell_spmv_ref(vals, cols, w), 3), (err, rel),
        bound(n * k * 8 + n * s * 4 + n * s * 4, 2 * nnz * s),
        cuda_ms(lambda: torch.sparse.mm(a_csr, w), 10))

    # 3. Φ_xᵀ α into [N, 16] (the chunked path's composed cross product).
    ax_t = csr(vals_x, cols_x, n, transpose=True)
    got = eops.ell_spmv_t(vals_x, cols_x, alpha, n)
    err, rel = rel_err(got, eref.ell_spmv_t_ref(vals_x, cols_x, alpha, n))
    expect(rel <= KERNEL_RTOL, f"ell_spmv_t at the main-path shape: rel {rel:.2e}")
    row("ell_spmv_t", cuda_ms(lambda: eops.ell_spmv_t(vals_x, cols_x, alpha, n), 50),
        cuda_ms(lambda: eref.ell_spmv_t_ref(vals_x, cols_x, alpha, n), 10), (err, rel),
        bound(t * k * 8 + t * s * 4 + n * s * 4, 2 * nnz_x * s),
        cuda_ms(lambda: torch.sparse.mm(ax_t, alpha), 20))

    # 4a. Fused K̂_{·x} α over all N rows (pathwise_samples' cross term).
    got = eops.khat_fused(vals, cols, vals_x, cols_x, alpha, n)
    err, rel = rel_err(got, eref.khat_matvec_ref(vals, cols, vals_x, cols_x, alpha, n))
    expect(rel <= KERNEL_RTOL, f"khat_fused at the main-path shape: rel {rel:.2e}")
    row("khat_fused",
        cuda_ms(lambda: eops.khat_fused(vals, cols, vals_x, cols_x, alpha, n), 20),
        cuda_ms(lambda: eref.khat_matvec_ref(vals, cols, vals_x, cols_x, alpha, n), 3),
        (err, rel),
        bound(n * k * 8 + t * k * 8 + t * s * 4 + n * s * 4,
              2 * (nnz + nnz_x) * s),
        cuda_ms(lambda: torch.sparse.mm(a_csr, torch.sparse.mm(ax_t, alpha)), 10))

    # 4b. The same kernel at the CG shape (square K̂_xx, R = 16), f32 and bf16.
    for dt in (torch.float32, torch.bfloat16):
        vx = vals_x.to(dt)
        got = eops.khat_fused(vx, cols_x, vx, cols_x, alpha, n)
        err, rel = rel_err(got, eref.khat_matvec_ref(vx, cols_x, vx, cols_x, alpha, n))
        expect(rel <= KERNEL_RTOL,
               f"khat_fused at the CG shape ({dt}): rel {rel:.2e}")
        ms = cuda_ms(lambda: eops.khat_fused(vx, cols_x, vx, cols_x, alpha, n), 100)
        pms = cuda_ms(lambda: eref.khat_matvec_ref(vx, cols_x, vx, cols_x, alpha, n), 20)
        # Square K̂_xx: rows and cols are one payload, read once.
        b = bound(t * k * (vx.element_size() + 4) + 2 * t * s * 4,
                  4 * nnz_x * s)
        zero_ms = cuda_ms(lambda: torch.zeros((n, s), device=dev), 100)
        print(f"[timing] khat_fused at the CG shape (T={t}, R={s}, {dt}): kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms, bound {b[0] * 1e3:.3f} us "
              f"({b[1]}), zeroing [N,{s}] f32 alone {zero_ms:.4f} ms, "
              f"max_abs_err {err:.3e} (rel {rel:.2e})")
    return rows


# --------------------------------------------------------------------------


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script measures the port on the card only",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the repro_torch package is not at {SRC}; run "
              "this script from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    phases = [
        ("device", lambda: phase_device(dev)),
        ("parity-walk", lambda: check_walk_cases(dev)),
        ("parity-ell", lambda: check_kernel_cases(dev)),
        ("main", lambda: phase_main(dev)),
        ("e2e", lambda: phase_e2e(dev)),
    ]
    results = {}
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            results[name] = fn()
        except Exception:   # report the failing phase, then fail the run
            traceback.print_exc()
            print(f"chip_smoke: phase {name} FAILED", file=sys.stderr)
            return 1
        print(f"[phase] {name} ok in {time.perf_counter() - t0:.1f} s")
    try:
        kernels = phase_timing(dev, results["main"])
    except Exception:
        traceback.print_exc()
        print("chip_smoke: phase timing FAILED", file=sys.stderr)
        return 1
    expect(len(kernels) == 4, "timing rows missing")
    print(f"[phase] all phases ok in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
