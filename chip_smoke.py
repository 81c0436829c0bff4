#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) end to end on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (the first failure ends the run with a
non-zero exit and no result line):

  1. device    card name, `nvidia-smi` name and power limit; build the eight
               CUDA kernels (one nvcc per source, in parallel) and print
               their `-Xptxas -v` registers / spills; the redesigned
               kernels (flash_attention's tensor-core instance, rmsnorm's
               16-byte instance, khat_fused's segment and gather kernels,
               gram_block's aggregate and probe kernels, the walk sampler,
               ell_spmv's row kernel, woodbury_apply's partials and finish
               kernels) must spill nothing.
  2. parity    each kernel against its plain PyTorch version on the card at
               ragged shapes (1-D and R in {3, 16}, duplicate columns, zero
               slots, every walk scheme, an isolated node, bf16 and mixed
               f32/bf16 K̂ payloads, the cross form over rows whose columns
               the column payload never touches, an empty column payload,
               gram_block at M_r = 1, K_r != K_c, every main-path shape and
               a side of 1 100 000 rows; khat_fused and gram_block bit-equal
               over two calls; ell_spmv's instances at R in {1-D, 1, 2, 3,
               4, 16, 17, 64} x K in {1, 7, 48, 144} x M in {0, 1, 33,
               65537}, on walk payloads of a ring and a preferential-
               attachment graph, and on a u and a payload off 16-byte
               alignment, bit-equal over two calls; the walk sampler at M
               in {1, 31, 33, one block + 1}, 1..16 walkers and l_max 0..63,
               woodbury_apply over T in {1, 37, 4000}, r in 1..263, R in
               1-D..65 and scalar / vector / masked D⁻¹, bit-equal over two
               calls, and on draws where float32 is far from float64
               (random E⁻¹; T < r with unit-scale B) within twice the plain
               version's own mean float64 error plus 1e-5 of scale), the walk
               golden checksums of the JAX reference, and the five
               autograd
               Functions against autograd through the plain versions;
               parity-lm-kernels: rmsnorm at the JAX tests' cases, the LM
               path's rows, every config width, M = 0, D = 2566 and an
               unaligned base; flash_attention at the JAX tests' nine cases
               and the LM shapes (danube at S = 1024 and 4608, window 4096;
               gemma2-27b's D = 144 with softcap 50; gemma3-4b's D = 320; a
               cross shape Sq = 128, Skv = 1500; B·H = 2049·32, past a grid
               dimension's 65535), f32 and bf16, and strided
               and misaligned bf16 views, each gated on the instance the
               routing rule names (bf16 with D ≤ 256, D % 8 = 0, aligned:
               the tensor cores).
  3. main      ring(10⁶, k=3), 8 walkers, p_halt 0.2, l_max 5 (K = 48),
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
  5. fit       fit_hyperparams on the main-path problem (N = 10⁶, T = 1024):
               20 warm-started steps in two chunks of 10, 8 probes; every
               step must converge.  One step's forward and backward launches
               apart, the warm step time and busy share, and three steps on
               the card against the CPU at N = 2·10⁴.
  6. serving   ring(10⁶), 16 walkers, p_halt 0.1, l_max 8 (K = 144),
               capacity 128: ingest 64, observe x3, posterior_moments on
               256 nodes, GPServeLoop(batch 64) over 512 nodes in requests
               of 16, thompson_draw over 512 candidates, refit_alpha; first
               call, warm median, peak memory and launches per call;
               incremental == from-scratch; card vs CPU at N = 2·10⁴.
  7. bo        thompson_sampling_incremental (64 initial, 6 rounds, refits
               at rounds 0 and 5, 512 candidates) and the refit engine's
               chunked path (2 rounds) at N = 10⁶; ms per round and regret.
  8. solvers   bench_solvers.py's clustered block at its full-mode width:
               ring(10⁶), K = 144, T = 4000 contiguous nodes, β = 4,
               σ_f = 25, σ² = 1e-2, tol 1e-6: solvers.solve under none,
               jacobi, nystrom (rank 128), auto, bf16 jacobi and nystrom,
               the Nyström build and a prebuilt solve apart, a warm start
               after f ← 1.02·f against the cold solve, exact_lml (32 probes
               x 64 SLQ iterations), 5 fit steps under nystrom (R = 9) and
               pathwise_samples_chunked under nystrom (R = 16).  Gates:
               convergence, agreement with "none", woodbury_apply launches
               = iterations + 1, gram_block launches = rank per build, SLQ
               within 5 % of the dense float64 log-det; card vs CPU at
               N = 2·10⁴ on the Nyström solve and exact_lml.
  9. lm        h2o-danube-1.8b at its published width (24 layers, bf16,
               random weights from seed 0): ServeLoop(batch 4, max_len 5120)
               answers 8 greedy requests of 32 tokens, 4 prompts of 1024
               tokens then 4 of 4608 (past the 4096 window).  Gates: every
               request gets its tokens, flash_attention launches 24 times per
               prefill, all on the tensor-core instance, and never in a
               decode step, rmsnorm 49 times per
               prefill and per step, finite logits.  Prefill ms (first,
               warm) per prompt length, decode ms per step and tokens/s,
               peak memory, launches per call, and the busy share of one
               decode step and one prefill.  Then, at full width cut to 2
               layers, f32, window 512: prefill(640) + 16 decode steps
               against forward on the card, and the card against the CPU,
               each within 1e-3.
 10. parity-baselines
               the shapes the baselines give the kernels: ell_spmv at R = 1024
               over [1024, 48] rows of the 10⁶-node trace (u 4 GiB) and at
               R = 4096 over [1024, 48] rows of a 65536-node ring (u 1 GiB),
               past 32 float4 lanes (column chunks), within 1e-5 of scale and
               bit-equal over two calls; walk_sampler at the SVGP trace
               (SBM 2500, 500 walkers, l_max 5, K = 3000) and the baselines'
               (grid 64x64, 100 walkers, l_max 10, K = 1100), bit-equal to
               the plain version for every scheme; each timed for the result
               line.
 11. baselines the paper's comparison where O(N³) runs: grid2d(64, 64),
               T = 1024, noise 0.1, the truth drawn through the port's
               eigendecomposition.  The exact GP (150-step exact-diffusion fit
               + Cholesky posterior; no kernel of the port) against the GRF-GP
               (100 walkers, p_halt 0.1, l_max 10; 80-step fit; 64 pathwise
               samples): test RMSE and NLPD, first and warm wall, peak memory,
               the GRF fit's and posterior's busy share; gates: finite scores,
               GRF RMSE within 1.5x the exact GP's, walk_sampler, khat_fused,
               ell_spmv and ell_spmv_t launched; the fused K̂ at the fit's CG
               shape [1024, 1100], R = 9; the exact path card vs CPU within
               1e-4 at N = 400; the wind twin at 2000 nodes.
 12. svgp      bench_classification.py's full mode: SBM(2500, 7), 80/20
               split, K = 3000, 150 inducing nodes, 600 steps: accuracy
               (gate: twice chance), ms a step and its busy share, beside the
               exact diffusion and Matérn classifiers; walk_sampler launched.
 13. jlt       the JLT + Woodbury solver: the JAX test's problem (grid2d(7, 7),
               m = 4096; gate: correlation with CG > 0.95), then the
               posterior cell's T = 1024 rows at N = 10⁶, m = 1024 (G 4 GiB):
               correlation, wall, peak; ell_spmv launched at R = 1024.
 14. obs       the main posterior calls, one fit chunk, one serving wave and
               one BO round under obs.recording(chiprun_out/obs.jsonl): the
               record validates, every expected span is there,
               walks.rows_sampled equals the rows of the walk kernel's
               launches, and the solver.cg histogram counts every solve; the
               summary table; then the same calls with obs disabled record
               and write nothing.
 15. timing    each kernel at the main-path shapes with CUDA events: kernel,
               plain version, library call where one exists, and the bound
               (ell_spmv at the prior draw [10⁶, 48] and one chunk each of
               [65536, 48] and [65536, 144], u [10⁶, 16], and the K = 144
               chunk with a 1-D u, as graph replays beside eager loops,
               bit-equal over two calls, against torch.sparse.mm, the
               bound counting the rows of u that the non-zero slots touch;
               ell_spmv_t as graph replays too;
               walk_sampler at the monolithic trace, one chunk of 65536
               rows and the wide K = 144 trace, bit-equal to the plain
               version for every scheme at each, the bound counting the
               adjacency rows of the nodes the walks visit;
               gram_block at each of its seven shapes, the Nyström pivot
               column among them, each against torch.sparse.mm;
               woodbury_apply at T = 4000 for r in {64, 128, 256} and R in
               {1, 9, 16} as graph replays beside eager loops, bit-equal
               over two calls; the K̂
               backward at the fit's shape; the fused
               kernel at the posterior's and the solvers' CG shapes and the
               cross form, through the walk trace's column index, whose
               build ms and U are printed, with two calls bit-equal and a
               profile of one CG iteration that must show no N-long fill;
               flash_attention at danube's prefill shapes, each instance as
               the device time of CUDA-graph replays, SDPA with a boolean
               mask and, at S = 1024, SDPA is_causal, with both the bf16
               tensor-core bound, used in the row, and the f32 one; rmsnorm
               at the LM rows, graph replays beside the eager loop, and the
               host µs per call against F.rms_norm); printed as one
               {"kernels": [...]} line.

The new shapes of phase 10 and khat_fused's at phase 11's CG shape join
their kernels' `shapes` lists in that line.

Each path (main, fit, serving, each BO loop, solvers, lm, baselines, svgp,
jlt, obs) is driven with every launch
count set to 0 just before it and read just after, and fails if a kernel it
runs was never launched; a kernel's `launches` in the result line is the
sum over those runs.  walk_sampler's launches are also printed by (M, K),
woodbury_apply's by (T, r, R) and ell_spmv's and ell_spmv_t's by (M, K, R),
per path and summed.

The last line is {"ok": true, "device": {...}}.  Without a CUDA card, or
without the repository beside this file, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import json
import math
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
BF16_TC_FLOP_PER_S = 989e12  # H100 SXM bf16 dense, on the tensor cores

# Tolerances, each relative to the largest |value| of the plain result:
#   walk cols/lens are integer results of the same hash — compared exactly;
#   walk loads repeat the plain version's float32 multiplications in the same
#   order — compared exactly as well (max_abs_err reported);
#   gather sums run over K slots in another order (and with FMA) than
#   PyTorch's einsum: 1e-5;
#   the scatter adds with float atomics in a run-dependent order and the
#   fused K̂ sums by column segments in an order of its own: 1e-5 (f32) and
#   1e-5 for bf16 payloads too, since both sides upcast the same bf16 values
#   exactly and accumulate in f32;
#   end-to-end results pass through CG (tol 1e-5 on the relative residual),
#   whose iterates amplify those rounding differences; chunked vs monolithic
#   and card vs CPU are held to 1e-4.
#   flash attention in float32 sums a softmax over ≤ 4608 keys in another
#   order than the plain version's einsum: 2e-5 (the JAX kernel test's);
#   rmsnorm in float32 differs by one row sum's order and rsqrtf (≤ 2 ulp):
#   1e-6; both kernels in bf16 compute in float32 and round once, as the
#   plain versions do: 2 bf16 ulps of the plain result's scale;
#   the LM path cut to 2 layers in float32 (decode vs forward, card vs CPU)
#   runs 656 positions through 2 layers and a 32000-way unembedding: 1e-3.
KERNEL_RTOL = 1e-5
E2E_RTOL = 1e-4
ATTN_RTOL = 2e-5
NORM_RTOL = 1e-6
BF16_ULPS = 2

GOLDEN = dict(seed=1214163296, cols_crc=1350745773, lens_crc=1932814751,
              loads_sum=144.53968, loads_tol=1e-4)

MAIN = dict(n_nodes=1_000_000, ring_k=3, n_walkers=8, p_halt=0.2, l_max=5,
            n_train=1024, sigma_n2=0.05, n_samples=16, chunk=65536)
E2E = dict(MAIN, n_nodes=20_000, n_train=256, chunk=4096)
# The fit on the main-path problem: warm-started MLL_DEFAULT, 8 probes.
FIT = dict(steps=20, chunk=10, n_probes=8)
# Serving at bench_serving.py's full-mode widths (K = 16·9 = 144 slots) and
# serve_gp.py's engine defaults (batch 64, requests of 16, 512 nodes).
SERVE = dict(n_nodes=1_000_000, ring_k=3, n_walkers=16, p_halt=0.1, l_max=8,
             capacity=128, sigma_n2=0.05, n_ingest=64, n_observe=3,
             n_moments=256, n_engine=512, batch=64, req=16, n_cand=512)
BO = dict(n_init=64, rounds=6, refit_every=5, refit_steps=10,
          n_candidates=512, chunked_rounds=2)
# The Nyström/SLQ stack on bench_solvers.py's operating point at its
# full-mode walker width (K = 16·9 = 144): T = 4√N contiguous ring nodes.
SOLVE = dict(n_nodes=1_000_000, ring_k=3, n_walkers=16, p_halt=0.1, l_max=8,
             beta=4.0, sigma_f=25.0, sigma_n2=1e-2, tol=1e-6, max_iters=3000,
             rank=128, lml_probes=32, slq_iters=64, fit_steps=5, fit_probes=8,
             n_samples=16, chunk=65536)
# ell_spmv's parity widths R (None: a 1-D u), which take both instances at
# several lane and part counts, and its parity row counts.
SPMV_WIDTHS = (None, 1, 2, 3, 4, 16, 17, 64)
SPMV_ROWS = (0, 1, 33, 65537)
# ell_spmv at the widths of the JLT features (rows × R): [1024, 48] rows of
# the 10⁶-node trace against u [10⁶, 1024] (4 GiB), and of a 65536-node ring
# against u [65536, 4096] (1 GiB; 16 GiB at 10⁶ nodes) — past 32 float4
# lanes a row, so in column chunks.
WIDE_SPMV = ((MAIN["n_nodes"], 1024), (65536, 4096))
# The paper's comparison where O(N³) still runs: grid2d(64, 64) (N = 4096),
# T = N/4, noise 0.1; quickstart.py's walks (K = 1100), 80-step fit, 64
# samples and 150-step exact fit.
BASE = dict(rows=64, cols=64, beta=6.0, noise=0.1, n_walkers=100, p_halt=0.1,
            l_max=10, fit_steps=80, lr=0.08, n_samples=64, exact_steps=150)
# bench_classification.py's full-mode SVGP: SBM(2500, 7), an 80/20 split,
# 500 walkers, p_halt 0.2, l_max 5 (K = 3000), 150 inducing nodes, 600 steps.
SVGP = dict(n_nodes=2500, n_classes=7, p_in=0.045, p_out=0.012, n_walkers=500,
            p_halt=0.2, l_max=5, n_inducing=150, steps=600, lr=0.08, n_mc=8)
# The JLT solver: the JAX test's width on grid2d(7, 7), and m = 1024 on the
# posterior cell's training rows (G [10⁶, 1024] is 4 GiB).
JLT = dict(m_small=4096, m_main=1024)
# woodbury_apply's timed shapes at T = 4000: ranks and RHS widths.
WOOD_RANKS = (64, 128, 256)
WOOD_COLS = (1, 9, 16)
# walk_sampler's timed shapes: the monolithic trace, one chunk of the
# chunked paths (core/walks.py DEFAULT_CHUNK rows) and the wide K = 144
# trace of the serving and solvers configurations.
WALK_SHAPES = (("monolithic", MAIN, MAIN["n_nodes"]), ("chunk", MAIN, MAIN["chunk"]),
               ("wide", SERVE, SERVE["n_nodes"]))
# gram_block's main-path shapes (M_r, K_r, M_c, K_c): factorisation and
# refit_alpha, one append, a wave, a moments call, the Thompson cross-Gram,
# the Thompson q×q Gram and the Nyström pivot column (solvers phase).
GRAM_SHAPES = [(128, 144, 128, 144), (1, 144, 128, 144), (64, 144, 128, 144),
               (256, 144, 128, 144), (512, 144, 128, 144), (512, 144, 512, 144),
               (4000, 144, 1, 144)]

# LM serving on h2o-danube-1.8b at its published width (24 layers, d_model
# 2560, 32/8 heads of 80, window 4096, bf16), random weights from the seed:
# ServeLoop(batch 4, max_len 5120), wave A of 4 prompts of 1024 tokens,
# wave B of 4 of 4608 (past the window: its masks and the ring-buffer wrap
# run at full width), 32 greedy tokens each.
LM = dict(arch="h2o-danube-1.8b", seed=0, batch=4, max_len=5120, new_tokens=32,
          waves=((4, 1024), (4, 4608)))
# The LM checks at full width cut to 2 layers, f32 activations and cache,
# window 512: prefill(640) + 16 teacher-forced decode steps.
LM_CHECK = dict(layers=2, window=512, prompt=640, steps=16, rtol=1e-3)
# flash_attention's parity cases ((b, h, hkv, sq, skv, d), kwargs): the JAX
# kernel tests' nine, B·H = 65568 (past a grid dimension's 65535), then
# danube's prefill at both prompt lengths, gemma2-27b's local layer (softcap
# 50), gemma3-4b's local layer (D = 320) and a cross-attention shape.
ATTN_CASES = [
    ((2, 4, 4, 128, 128, 32), {}),
    ((1, 8, 2, 128, 128, 32), {}),
    ((1, 4, 2, 96, 96, 32), {}),
    ((1, 2, 2, 64, 64, 32), dict(causal=False)),
    ((1, 4, 4, 128, 128, 32), dict(window=48)),
    ((1, 4, 4, 128, 128, 32), dict(softcap=30.0)),
    ((1, 4, 2, 128, 256, 32), dict(causal=False)),
    ((1, 4, 4, 128, 128, 32), dict(window=32, softcap=20.0)),
    ((1, 2, 1, 40, 40, 16), {}),
    ((2049, 32, 8, 16, 16, 64), {}),
    ((1, 32, 8, 1024, 1024, 80), dict(window=4096)),
    ((1, 32, 8, 4608, 4608, 80), dict(window=4096)),
    ((1, 32, 16, 4608, 4608, 144), dict(window=4096, softcap=50.0)),
    ((1, 8, 4, 2048, 2048, 320), dict(window=1024)),
    ((1, 8, 8, 128, 1500, 64), dict(causal=False)),
]
# The LM path's rmsnorm rows: a prefill at each prompt length, a decode step.
NORM_SHAPES = [(4608, 2560), (1024, 2560), (4, 2560)]

REPLACES = {
    "walk_sampler": "src/repro/kernels/walk_sampler/walk_sampler.py:59",
    "ell_spmv": "src/repro/kernels/ell_spmv/ell_spmv.py:42",
    "ell_spmv_t": "src/repro/kernels/ell_spmv/ell_spmv_t.py:48",
    "khat_fused": "src/repro/kernels/ell_spmv/khat_fused.py:83",
    "gram_block": "src/repro/kernels/gram_block/gram_block.py:59",
    "woodbury_apply": "src/repro/kernels/woodbury_apply/woodbury_apply.py:75",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:104",
    "rmsnorm": "src/repro/kernels/rmsnorm/rmsnorm.py:27",
}


# Kernel functions of the redesigned kernels, by library, whose ptxas spills
# are gated at 0: flash_attention's tensor-core instance, rmsnorm's 16-byte
# instance, khat_fused's two kernels, gram_block's two, the walk sampler,
# ell_spmv's row kernel and woodbury_apply's two.
REDESIGNED = {"flash_attention": ("flash_fwd_tc",), "rmsnorm": ("rmsnorm_vec",),
              "khat_fused": ("khat_segments", "khat_gather"),
              "gram_block": ("gram_aggregate", "gram_probe"),
              "walk_sampler": ("walk_sample_kernel",),
              "ell_spmv": ("ell_spmv_rows",),
              "woodbury_apply": ("wb_partials", "wb_finish")}


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


def mib(nbytes) -> str:
    return "n/a" if nbytes is None else f"{nbytes / 2**20:.0f}"


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
    print(f"[build] {len(build.SOURCES)} kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for name, lines in build.ptxas_report().items():
        for ln in lines.splitlines():
            print(f"[ptxas] {name}: {ln.strip()}")
    # The redesigned kernels spill nothing.
    redesigned = []
    for lib, names in REDESIGNED.items():
        found = [f for f in build.ptxas_functions(lib)
                 if any(k in f["function"] for k in names)]
        expect(all(any(k in f["function"] for f in found) for k in names),
               f"no ptxas entry for a redesigned kernel of {lib}")
        redesigned += found
    for f in redesigned:
        print(f"[ptxas] redesigned {f['function']}: {f['registers']} registers, "
              f"spill stores {f['spill_stores']} B, spill loads {f['spill_loads']} B")
    spilling = [f["function"] for f in redesigned
                if f["spill_stores"] or f["spill_loads"]]
    expect(not spilling, f"redesigned instances spill: {spilling}")
    print(f"[ptxas] {len(redesigned)} redesigned instances, no spills")
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
    check_spmv_cases(dev, rng)
    check_khat_index_cases(dev, rng)


def check_spmv_cases(dev, rng) -> None:
    """ell_spmv's instances: R in SPMV_WIDTHS x K in {1, 7, 48, 144} x M in
    {0, 1, 33, 65537} on random payloads (35 % zero slots), walk payloads
    of a ring and of a preferential-attachment graph (halted walkers:
    zero slots on real columns) at K = 48 and 144, and a u and a payload
    sliced off 16-byte alignment (the scalar instance, 4-byte payload
    loads); within 1e-5 of scale, two calls bit-equal, one launch a call
    (none for M = 0)."""
    import torch

    from repro_torch.core import features, modulation, walks
    from repro_torch.graphs import generators
    from repro_torch.kernels.ell_spmv import ops, ref

    t = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731

    def held(label, vals, cols, u):
        before = ops.LAUNCHES["ell_spmv"]
        got = ops.ell_spmv_raw(vals, cols, u)
        again = ops.ell_spmv_raw(vals, cols, u)
        launched = ops.LAUNCHES["ell_spmv"] - before
        expect(launched == (2 if got.numel() else 0),
               f"ell_spmv {label}: {launched} launches for two calls")
        expect(torch.equal(got, again), f"ell_spmv {label}: two calls differ")
        _, rel = rel_err(got, ref.ell_spmv_ref(vals, cols, u))
        expect(rel <= KERNEL_RTOL, f"ell_spmv {label}: rel {rel:.2e}")
        return rel

    n, cases, worst = 5003, 0, 0.0
    routes = set()
    for r in SPMV_WIDTHS:
        u = t(rng.standard_normal((n,) if r is None else (n, r)).astype(np.float32))
        for k in (1, 7, 48, 144):
            for m in SPMV_ROWS:
                vals, cols = _payload(rng, m, k, n, False, 0.35)
                worst = max(worst, held(f"m={m} k={k} r={r}", t(vals), t(cols), u))
                cases += 1
            routes.add(ops.route(r or 1, True))
    for kind in ("ring", "barabasi_albert"):
        g = (generators.ring(4000, k=3, device=dev) if kind == "ring"
             else generators.barabasi_albert(4000, m=3, seed=1, device=dev))
        for nw, ph, lm in ((8, 0.2, 5), (16, 0.1, 8)):
            mod = modulation.diffusion(lm)
            tr = walks.sample_walks(g, 2024, nw, ph, lm)
            vals = features.feature_values(tr, mod(mod.init(device=dev))).contiguous()
            expect(bool((vals == 0).any()), f"ell_spmv {kind}: no halted slots")
            for r in (None, 1, 16):
                u = torch.randn((4000,) if r is None else (4000, r), device=dev)
                worst = max(worst, held(f"{kind} K={vals.shape[1]} r={r}",
                                        vals, tr.cols, u))
                cases += 1
    vals, cols = map(t, _payload(rng, 1000, 48, 777, False, 0.3))
    for r in (None, 4, 16):
        width = r or 1
        flat = torch.randn(777 * width + 1, device=dev)[1:]
        u = flat if r is None else flat.view(777, r)
        expect(ops.route(width, ops.aligned(u))[0] == ops.SCALAR,
               f"ell_spmv: an unaligned u of R = {width} routes to the vector instance")
        worst = max(worst, held(f"unaligned u r={r}", vals, cols, u))
        pv = torch.cat([vals.new_zeros(1), vals.reshape(-1)])[1:].view(1000, 48)
        pc = torch.cat([cols.new_zeros(1), cols.reshape(-1)])[1:].view(1000, 48)
        worst = max(worst, held(f"unaligned payload r={r}", pv, pc, u))
        cases += 2
    print(f"[parity] ell_spmv matches its plain version within {KERNEL_RTOL:g} of "
          f"scale (worst {worst:.2e}) and repeats bit for bit in {cases} cases: "
          f"instances {sorted(routes)}, walk payloads of a ring and a "
          "preferential-attachment graph, unaligned u and payloads")


def check_khat_index_cases(dev, rng) -> None:
    """khat_fused through a column index: the cross form over 50 000 rows
    whose columns the 1024-row column payload mostly never touches, every
    pairing of f32 and bf16 payloads, 1-D and R = 16, an empty column
    payload; two calls bit-equal."""
    import torch

    from repro_torch.kernels.ell_spmv import index as kindex
    from repro_torch.kernels.ell_spmv import ops, ref

    t = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
    n = 200_000
    vr, cr = map(t, _payload(rng, 50_000, 48, n, False, 0.2))
    vc, cc = map(t, _payload(rng, 1024, 48, n, True, 0.3))   # columns < n/50
    f32, bf16 = torch.float32, torch.bfloat16
    cases = 0
    for r in (None, 16):
        v = t(rng.standard_normal((1024,) if r is None else (1024, r))
              .astype(np.float32))
        for dr, dc in ((f32, f32), (bf16, bf16), (bf16, f32), (f32, bf16)):
            a, b = vr.to(dr), vc.to(dc)
            idx = kindex.column_index(cc, b, n)
            got = ops.khat_fused_raw(a, cr, b, cc, v, n, idx)
            expect(torch.equal(got, ops.khat_fused_raw(a, cr, b, cc, v, n, idx)),
                   f"khat_fused cross R={r} {dr}/{dc}: two calls differ")
            _, rel = rel_err(got, ref.khat_matvec_ref(a, cr, b, cc, v, n))
            expect(rel <= KERNEL_RTOL,
                   f"khat_fused cross R={r} {dr}/{dc}: rel {rel:.2e}")
            cases += 1
    untouched = float((idx.node_map[cr.long()] < 0).float().mean())
    empty = ops.khat_fused_raw(vr, cr, vc[:0], cc[:0], v[:0], n)
    expect(tuple(empty.shape) == (50_000, 16) and not bool(empty.any()),
           "khat_fused with an empty column payload")
    print(f"[parity] khat_fused through the column index matches its plain "
          f"version within {KERNEL_RTOL:g} of scale and repeats bit for bit in "
          f"{cases} cross-form cases (f32, bf16 and mixed payloads, 1-D and "
          f"R = 16; {100 * untouched:.1f}% of row slots on untouched columns, "
          f"U = {idx.n_uniq}); an empty column payload gives 0")


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
    # The kernel's tiles: one row, rows on both sides of a block's walks
    # (256 threads, fewer past 24 steps), 1..16 walkers, l_max 0..63.
    edges_cases = 0
    for w, l_max in [(1, 0), (3, 5), (8, 5), (16, 8), (1, 63), (3, 63)]:
        per_block = min(256, (6144 // (l_max + 1)) & ~31) // w
        for m in sorted({1, 31, 33, per_block + 1}):
            for scheme in ("iid", "qmc"):
                kw = dict(n_walkers=w, p_halt=0.2, l_max=l_max, reweight=False,
                          scheme=scheme)
                got = ops.walk_sample(g.neighbors, g.weights, g.deg, nodes[:m], 55, **kw)
                want = ref.walk_sample_ref(g.neighbors, g.weights, g.deg, nodes[:m], 55,
                                           **kw)
                expect(all(torch.equal(a, b) for a, b in zip(got, want)),
                       f"walk kernel differs at M={m}, {kw}")
                edges_cases += 1
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
          f"for 4 schemes x 3 configs (M=777, isolated node) and {edges_cases} "
          "tile cases (M in 1/31/33/block+1, 1..16 walkers, l_max 0..63); JAX "
          f"golden cols crc {c_crc}, lens crc {l_crc}, loads sum {s:.5f}")


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
    """Run one warm pass of ``calls``, profiling those in ``labels`` (see
    :func:`profile_busy`)."""
    for label, fn in calls:
        if label in labels:
            profile_busy(label, fn, dev, warm[label])
        else:
            fn()


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
    record_shapes("main")
    for name in ("walk_sampler", "ell_spmv", "ell_spmv_t", "khat_fused"):
        expect(counts[name] > 0, f"main path never launched {name}")
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
# Slice 2: cross-Gram and autograd parity, the fit, serving and BO paths
# --------------------------------------------------------------------------


def _gram_payload(rng, m, k, n, dup: bool, zero_frac: float):
    """Random ELL payload; zero-valued slots carry column 0 (as the walk
    sampler pads), and with ``dup`` every row repeats columns."""
    vals = rng.standard_normal((m, k)).astype(np.float32)
    cols = rng.integers(0, n, (m, k)).astype(np.int32)
    if dup:
        cols[:, 1::3] = cols[:, :1]
    pad = rng.random((m, k)) < zero_frac
    vals[pad] = 0.0
    cols[pad] = 0
    return vals, cols


def check_gram_cases(dev) -> None:
    """gram_block against its plain version at ragged shapes and at every
    main-path shape, then the four autograd Functions on the card against
    autograd through their plain versions on the card."""
    import torch

    from repro_torch.kernels.ell_spmv import ops as eops
    from repro_torch.kernels.ell_spmv import ref as eref
    from repro_torch.kernels.gram_block import ops, ref

    rng = np.random.default_rng(12)
    t = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
    cases = 0
    # (M_r, K_r, M_c, K_c): M_r = 1; M_c past one 16-row tile; K_r ≠ K_c;
    # K past one 128-slot shared-memory chunk; then the main-path shapes.
    shapes = [(1, 7, 9, 5), (37, 13, 300, 7), (70, 200, 33, 150),
              (16, 129, 17, 130), (3, 1, 1000, 2)] + GRAM_SHAPES
    for (m_r, k_r, m_c, k_c) in shapes:
        for dup in (False, True):
            vr, cr = _gram_payload(rng, m_r, k_r, 5000, dup, 0.3)
            vc, cc = _gram_payload(rng, m_c, k_c, 5000, dup, 0.3)
            got = ops.gram_block_raw(t(vr), t(cr), t(vc), t(cc))
            want = ref.gram_block_ref(t(vr), t(cr), t(vc), t(cc))
            _, rel = rel_err(got, want)
            expect(rel <= KERNEL_RTOL,
                   f"gram_block {m_r}x{k_r} by {m_c}x{k_c} dup={dup}: rel {rel:.2e}")
            expect(torch.equal(got, ops.gram_block_raw(t(vr), t(cr), t(vc), t(cc))),
                   f"gram_block {m_r}x{k_r} by {m_c}x{k_c}: two calls differ")
            cases += 1
    empty = ops.gram_block_raw(t(vr[:0]), t(cr[:0]), t(vc), t(cc))
    expect(tuple(empty.shape) == (0, m_c), "gram_block empty M_r")
    # A side of 1 100 000 rows at K = 4, as rows and as columns.
    vr, cr = map(t, _gram_payload(rng, 40, 4, 50_000, True, 0.3))
    vc, cc = map(t, _gram_payload(rng, 1_100_000, 4, 50_000, True, 0.3))
    got = ops.gram_block_raw(vr, cr, vc, cc)
    _, rel = rel_err(got, ref.gram_block_ref(vr, cr, vc, cc))
    _, rel_t = rel_err(ops.gram_block_raw(vc, cc, vr, cr), got.T)
    expect(max(rel, rel_t) <= KERNEL_RTOL,
           f"gram_block with a side of 1 100 000 rows: rel {rel:.2e} / {rel_t:.2e}")
    cases += 2
    print(f"[parity] gram_block matches its plain version within {KERNEL_RTOL:g} "
          f"of scale, and repeats bit for bit, in {cases} cases (ragged, "
          f"duplicates, zero slots, M_r = 1, K_r != K_c, every main-path shape, "
          f"a side of 1 100 000 rows)")

    def grads(fn, args, diff, g):
        ts = list(args)
        leaves = []
        for i in diff:
            ts[i] = ts[i].clone().requires_grad_()
            leaves.append(ts[i])
        return torch.autograd.grad(fn(*ts), leaves, g)

    n = 5003
    vr, cr = map(t, _gram_payload(rng, 300, 48, n, True, 0.3))
    vc, cc = map(t, _gram_payload(rng, 77, 40, n, True, 0.3))
    u = t(rng.standard_normal((n, 9)).astype(np.float32))
    v = t(rng.standard_normal((77, 9)).astype(np.float32))
    w = t(rng.standard_normal((300, 9)).astype(np.float32))
    funcs = [
        ("gram_block", ops.gram_block, ref.gram_block_ref, [vr, cr, vc, cc],
         (0, 2), (300, 77)),
        ("ell_spmv", eops.ell_spmv, eref.ell_spmv_ref, [vr, cr, u], (0, 2),
         (300, 9)),
        ("ell_spmv_t", lambda a, c, b: eops.ell_spmv_t(a, c, b, n),
         lambda a, c, b: eref.ell_spmv_t_ref(a, c, b, n), [vr, cr, w], (0, 2),
         (n, 9)),
        ("khat_fused", lambda a, ca, b, cb, c: eops.khat_fused(a, ca, b, cb, c, n),
         lambda a, ca, b, cb, c: eref.khat_matvec_ref(a, ca, b, cb, c, n),
         [vr, cr, vc, cc, v], (0, 2, 4), (300, 9)),
    ]
    for name, fn, plain, args, diff, gshape in funcs:
        g = t(rng.standard_normal(gshape).astype(np.float32))
        before = counts_now()
        got_all = grads(fn, args, diff, g)
        after = counts_now()
        print(f"[parity] {name} forward + backward (all cotangents) launched "
              + json.dumps({k: after[k] - before[k] for k in after
                            if after[k] != before[k]}))
        for i, (got, want) in enumerate(zip(got_all,
                                             grads(plain, args, diff, g))):
            _, rel = rel_err(got, want)
            expect(rel <= KERNEL_RTOL,
                   f"{name} autograd cotangent {diff[i]}: rel {rel:.2e}")
    print("[parity] autograd: gram_block, ell_spmv, ell_spmv_t and khat_fused "
          "cotangents on the card match autograd through their plain versions "
          f"within {KERNEL_RTOL:g} of scale")


# --------------------------------------------------------------------------
# Slice 3: the Woodbury apply and the Nyström/SLQ solver stack
# --------------------------------------------------------------------------


def _wood_inputs(rng, t: int, r: int, cols, noise: str):
    """B [T, r], D⁻¹ [T], a non-symmetric E⁻¹ [r, r] and v [T(, R)].

    ``noise``: "scalar" (one σ²), "vector" (heteroscedastic, with zero-noise
    rows whose D⁻¹ is 1.0), "masked" (1e6 noise, D⁻¹ = 1e-6, on a third of
    the rows)."""
    b = (rng.standard_normal((t, r)) / np.sqrt(r)).astype(np.float32)
    einv = (rng.standard_normal((r, r)) / np.sqrt(r)).astype(np.float32)
    if noise == "scalar":
        dinv = np.full(t, 1.0 / 0.05, np.float32)
    elif noise == "vector":
        dinv = (1.0 / rng.uniform(0.01, 1.0, t)).astype(np.float32)
        dinv[::5] = 1.0
    else:
        dinv = np.full(t, 1.0 / 0.05, np.float32)
        dinv[rng.random(t) < 1 / 3] = 1e-6
    v = rng.standard_normal((t,) if cols is None else (t, cols)).astype(np.float32)
    return b, dinv, einv, v


def _wood_capacity_inputs(rng, t: int, r: int, cols, noise: str):
    """As _wood_inputs, but E⁻¹ is the inverse of the capacitance
    E = I + BᵀD⁻¹B, as the Nyström preconditioner builds it, made
    non-symmetric by an upper-triangular term of a tenth of its scale (so
    that E⁻ᵀ ≠ E⁻¹ shows)."""
    b, dinv, _, v = _wood_inputs(rng, t, r, cols, noise)
    e = np.eye(r) + b.T.astype(np.float64) @ (dinv[:, None].astype(np.float64) * b)
    einv = np.linalg.inv(e)
    einv = einv + 0.1 * np.abs(einv).max() * np.triu(np.ones((r, r)), 1)
    return b, dinv, einv.astype(np.float32), v


def _wood_unit_b_inputs(rng, t: int, r: int, cols):
    """Unit-scale B [T, r], a D⁻¹ in (2/3, 2) with every fourth entry 1.0,
    E⁻¹ = (I + BᵀD⁻¹B)⁻¹ and v [T(, R)].  With T < r, out = w − D⁻¹Bs
    cancels w to about 1/(1 + r) of its scale, so float32 in any summation
    order is far from float64 there."""
    b = rng.standard_normal((t, r)).astype(np.float32)
    dinv = (1.0 / (0.5 + rng.random(t))).astype(np.float32)
    dinv[::4] = 1.0
    e = np.eye(r) + b.T.astype(np.float64) @ (dinv[:, None].astype(np.float64) * b)
    v = rng.standard_normal((t,) if cols is None else (t, cols)).astype(np.float32)
    return b, dinv, np.linalg.inv(e).astype(np.float32), v


def check_woodbury_cases(dev) -> None:
    """woodbury_apply against its plain version over T x r x R x noise kinds,
    each result bit-equal over two calls; then its autograd Function (d_v on
    the kernel with E⁻ᵀ, payload cotangents through the plain version)
    against autograd through the plain version; then r = 263, R = 65 on
    capacitance-inverse operands; then draws on which float32 itself is far
    from float64 (random E⁻¹; T < r with unit-scale B), held to a float64
    reference: the kernel's mean error over 8 draws at most twice the plain
    version's own plus 1e-5 of scale.  All on the card."""
    import torch

    from repro_torch.kernels.woodbury_apply import ops, ref

    rng = np.random.default_rng(13)
    t_ = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
    cases = 0
    worst = 0.0

    def case(arrs):
        nonlocal cases, worst
        b, dinv, einv, v = map(t_, arrs)
        t, r = b.shape
        want = ref.woodbury_apply_ref(b, dinv, einv, v)
        width = 1 if v.dim() == 1 else v.shape[1]
        before = ops.LAUNCHES["woodbury_apply"]
        got = ops.woodbury_apply_raw(b, dinv, einv, v)
        expect(ops.LAUNCHES["woodbury_apply"] == before + -(-width // ops.launch_cols(r)),
               f"woodbury_apply T={t} r={r} R={width}: launches "
               f"{ops.LAUNCHES['woodbury_apply'] - before}")
        _, rel = rel_err(got, want)
        expect(got.shape == v.shape and rel <= KERNEL_RTOL,
               f"woodbury_apply T={t} r={r} R={width}: rel {rel:.2e}")
        expect(torch.equal(got, ops.woodbury_apply_raw(b, dinv, einv, v)),
               f"woodbury_apply T={t} r={r} R={width}: two calls differ")
        worst = max(worst, rel)
        cases += 1

    for t in (1, 37, 4000):
        for r in (1, 7, 64, 128, 256):
            for cols in (None, 3, 9, 16, 64):
                for noise in ("scalar", "vector", "masked"):
                    case(_wood_inputs(rng, t, r, cols, noise))
    # A v wider than one launch's columns runs as several launches.
    case(_wood_inputs(rng, 333, 64, 100, "vector"))

    for cols in (None, 9):
        b, dinv, einv, v = map(t_, _wood_inputs(rng, 4000, 128, cols, "masked"))
        g = t_(rng.standard_normal(tuple(v.shape)).astype(np.float32))
        leaves = [x.clone().requires_grad_() for x in (b, dinv, einv, v)]
        before = ops.LAUNCHES["woodbury_apply"]
        got_all = torch.autograd.grad(ops.woodbury_apply(*leaves), leaves, g)
        launched = ops.LAUNCHES["woodbury_apply"] - before
        expect(launched == 2, f"woodbury_apply forward + d_v launched {launched}")
        plain = [x.clone().requires_grad_() for x in (b, dinv, einv, v)]
        want_all = torch.autograd.grad(ref.woodbury_apply_ref(*plain), plain, g)
        for name, got, want in zip(("b", "dinv", "einv", "v"), got_all, want_all):
            _, rel = rel_err(got, want)
            expect(rel <= KERNEL_RTOL,
                   f"woodbury_apply autograd d_{name} (R={cols}): rel {rel:.2e}")
        # d_v alone: the same kernel with E⁻ᵀ, no plain-version backward.
        vv = v.clone().requires_grad_()
        (d_v,) = torch.autograd.grad(ops.woodbury_apply(b, dinv, einv, vv), vv, g)
        _, rel = rel_err(d_v, want_all[3])
        expect(rel <= KERNEL_RTOL, f"woodbury_apply d_v alone: rel {rel:.2e}")
    print("[parity] woodbury_apply autograd: d_v (the kernel with E⁻ᵀ) and "
          "d_b, d_dinv, d_einv match autograd through the plain version within "
          f"{KERNEL_RTOL:g} of scale (R = 1-D and 9; forward + d_v = 2 launches)")

    rng = np.random.default_rng(17)
    for t in (1, 37, 4000):
        for r, cols in ((263, None), (263, 16), (37, 65), (128, 65), (263, 65)):
            case(_wood_capacity_inputs(rng, t, r, cols, "vector"))
    print(f"[parity] woodbury_apply matches its plain version within "
          f"{KERNEL_RTOL:g} of scale and is bit-equal over two calls in {cases} "
          f"cases (T in 1/37/4000, r in 1..263, R in 1-D/3/9/16/64/65/100, "
          f"scalar/vector/masked D⁻¹; worst rel {worst:.2e})")

    # Draws on which float32 is far from float64: 8 random-E⁻¹ draws (B of
    # unit rows) and 8 unit-scale-B draws with T < r at each shape.  Each
    # error is taken against the float64 result and divided by its scale;
    # the gate holds the mean over a shape's draws, since two float32
    # summation orders part by 2-3x on single draws.
    rng = np.random.default_rng(23)
    groups = [("random E⁻¹", (t, r, cols),
               lambda t, r, cols, noise=noise: _wood_inputs(rng, t, r, cols, noise))
              for t, r, cols, noise in ((1, 64, 16, "masked"), (1, 263, 65, "masked"),
                                        (37, 263, 65, "vector"), (4000, 128, 9, "masked"))]
    groups += [("unit B, T < r", shape,
                lambda t, r, cols: _wood_unit_b_inputs(rng, t, r, cols))
               for shape in ((1, 64, 16), (1, 263, 65), (37, 128, 9), (37, 263, 65))]
    for kind, (t, r, cols), make in groups:
        k64, p64 = [], []
        for _ in range(8):
            b, dinv, einv, v = map(t_, make(t, r, cols))
            want64 = ref.woodbury_apply_ref(b.double(), dinv.double(), einv.double(),
                                            v.double())
            got = ops.woodbury_apply_raw(b, dinv, einv, v)
            expect(torch.equal(got, ops.woodbury_apply_raw(b, dinv, einv, v)),
                   f"woodbury_apply {kind} T={t} r={r} R={cols}: two calls differ")
            k64.append(rel_err(got, want64)[1])
            p64.append(rel_err(ref.woodbury_apply_ref(b, dinv, einv, v), want64)[1])
        k64, p64 = np.array(k64), np.array(p64)
        print(f"[parity] woodbury_apply against float64, {kind} T={t} r={r} R={cols} "
              f"(8 draws): kernel mean {k64.mean():.3e} max {k64.max():.3e}, plain "
              f"float32 mean {p64.mean():.3e} max {p64.max():.3e} of scale; per-draw "
              f"ratio median {np.median(k64 / p64):.2f} max {(k64 / p64).max():.2f}")
        expect(k64.mean() <= 2 * p64.mean() + KERNEL_RTOL,
               f"woodbury_apply {kind} T={t} r={r} R={cols}: kernel {k64.mean():.2e} "
               f"of scale from float64 on average, plain float32 {p64.mean():.2e}")


def reset_counts():
    from repro_torch.kernels import dispatch

    dispatch.reset_launch_counts()


def counts_now() -> dict:
    from repro_torch.kernels import dispatch

    return dispatch.launch_counts()


# Launches by shape per path (walk_sampler, woodbury_apply, the ELL products).
PATH_SHAPES: dict = {}


def record_shapes(label: str) -> None:
    """Keep and print the launches by shape since the last reset of the
    counts (walk_sampler by (M, K), woodbury_apply by (T, r, R), ell_spmv
    and ell_spmv_t by (M, K, R))."""
    from repro_torch.kernels import dispatch

    PATH_SHAPES[label] = shapes = dispatch.launch_shapes()
    for name, by in shapes.items():
        if by:
            print(f"[{label}] {name} launches by shape: " + ", ".join(
                f"{'x'.join(map(str, k))}: {n}" for k, n in sorted(by.items(), key=str)))


def gate_counts(label: str, counts: dict, names) -> None:
    for name in names:
        expect(counts[name] > 0, f"{label} path never launched {name}")
    print(f"[{label}] launches over the {label} path: {json.dumps(counts)}")
    record_shapes(label)


def profile_busy(label: str, fn, dev, warm_s: float) -> dict:
    """Profile one call of ``fn``; print its device busy time (sum of CUDA
    kernel, memset and memcpy times on the device) and its five largest
    kernels.  The busy and idle shares divide that time by the call's
    unprofiled warm wall time ``warm_s``: the profiler inflates the wall
    time of the call it traces, so a share of the profiled wall would
    understate how busy the card is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
        return {}
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    share = busy_ms / (warm_s * 1e3)
    print(f"[trace] {label}: device busy {busy_ms:.2f} ms of {warm_s * 1e3:.2f} "
          f"ms warm wall ({100 * share:.1f}%), idle share "
          f"{100 * (1 - share):.1f}% (profiled wall {wall * 1e3:.2f} ms); top: "
          + "; ".join(f"{n[:48]} {tt / 1e3:.3f} ms" for n, tt in top))
    return dict(busy_ms=busy_ms, idle=1 - share)


def fit_problem(cfg: dict, dev):
    """The fit on the posterior path's problem: (graph, trace_x, mod, y, probes)."""
    import torch

    from repro_torch.core import modulation, walks

    graph, wcfg, _, train, y = make_problem(cfg, dev)
    seed = walks.walk_seed(torch.Generator().manual_seed(7))
    trace_x = walks.sample_walks_for_nodes(graph, train, seed, wcfg.n_walkers,
                                           wcfg.p_halt, wcfg.l_max)
    mod = modulation.diffusion(l_max=cfg["l_max"])
    probes = torch.from_numpy(
        (np.random.default_rng(5).integers(0, 2, (cfg["n_train"], FIT["n_probes"]))
         * 2 - 1).astype(np.float32)).to(dev)
    return graph, trace_x, mod, y, probes


def fit_chunk(trace_x, mod, y, n, probes, steps: int, dev, params=None,
              opt_state=None, v=None):
    """``steps`` warm-started Adam steps of the fit on the given probes."""
    import torch

    from repro_torch import solvers
    from repro_torch.gp import mll
    from repro_torch.optim import AdamW

    opt = AdamW(lr=0.05)
    if params is None:
        params = mll.init_hyperparams(mod, device=dev)
        opt_state = opt.init(params)
        v = torch.zeros((y.shape[0], 1 + FIT["n_probes"]), device=dev)
    return mll._fit_chunk(params, opt_state, None, trace_x, y,
                          torch.ones_like(y), v, mod=mod, opt=opt, n_nodes=n,
                          n_probes=FIT["n_probes"], strategy=solvers.MLL_DEFAULT,
                          chunk=steps, probes=probes)


def phase_fit(dev) -> dict:
    """fit_hyperparams at N = 10⁶ (20 steps in two chunks of 10), one step
    split into its forward and backward launches, the warm step time, its
    device busy share, and card vs CPU at N = 2·10⁴."""
    import torch

    from repro_torch import solvers
    from repro_torch.core import walks
    from repro_torch.gp import mll

    n = MAIN["n_nodes"]
    graph, trace_x, mod, y, probes = fit_problem(MAIN, dev)
    reset_counts()

    def fit():
        return mll.fit_hyperparams(
            trace_x, mod, y, n, torch.Generator(device=dev).manual_seed(11),
            steps=FIT["steps"], chunk=FIT["chunk"], n_probes=FIT["n_probes"],
            strategy=solvers.MLL_DEFAULT)

    res, wall, peak = timed_call(fit, dev)
    counts = counts_now()
    gate_counts("fit", counts, ("khat_fused", "ell_spmv_t"))
    for h in res.history:
        print(f"[fit] step {h['step']:2d}: loss {h['loss']:.4f}, sigma_n2 "
              f"{h['sigma_n2']:.5f}, cg_iters {h['cg_iters']}, converged "
              f"{h['cg_converged']}")
        expect(h["cg_converged"] and np.isfinite(h["loss"]),
               f"fit step {h['step']} did not converge or has a non-finite loss")
    expect(len(res.history) == FIT["steps"], "fit history is missing steps")
    warm_fit = float(np.median([timed_call(fit, dev)[1] for _ in range(3)]))
    print(f"[fit] fit_hyperparams, {FIT['steps']} steps (2 chunks of "
          f"{FIT['chunk']}): first call {wall * 1e3:.1f} ms "
          f"({wall / FIT['steps'] * 1e3:.2f} ms per step), warm median "
          f"{warm_fit * 1e3:.1f} ms ({warm_fit / FIT['steps'] * 1e3:.2f} ms per "
          f"step, of 3), max_memory_allocated {peak / 2**20:.0f} MiB")

    # One step, forward and backward apart: the backward's launches.
    params = mll.init_hyperparams(mod, device=dev)
    leaves = [params["mod"]["log_beta"], params["mod"]["log_sigma_f"],
              params["log_sigma_n"]]
    for leaf in leaves:
        leaf.requires_grad_(True)
    v0 = torch.zeros((y.shape[0], 1 + FIT["n_probes"]), device=dev)
    reset_counts()
    loss, aux = mll.mll_surrogate_loss(params, None, trace_x, mod, y, n,
                                       n_probes=FIT["n_probes"],
                                       strategy=solvers.MLL_DEFAULT,
                                       probes=probes, x0=v0)
    fwd = counts_now()
    torch.autograd.grad(loss, leaves)
    sync(dev)
    total = counts_now()
    bwd = {k: total[k] - fwd[k] for k in total}
    print(f"[fit] one step: forward launches {json.dumps(fwd)} (CG "
          f"{aux['cg_iters']} iterations); backward launches {json.dumps(bwd)}")
    expect(bwd["ell_spmv_t"] > 0, "the fit's backward launched no ell_spmv_t")
    expect(fwd["khat_fused"] > 0, "the fit's step launched no khat_fused")

    # Warm single-step time (median of 3), and its device busy share.
    state = fit_chunk(trace_x, mod, y, n, probes, 1, dev)

    def step():
        return fit_chunk(trace_x, mod, y, n, probes, 1, dev, *state[:3])

    step()
    walls = [timed_call(step, dev)[1] for _ in range(3)]
    warm = float(np.median(walls))
    it = int(step()[3][3][0])
    print(f"[fit] warm step {warm * 1e3:.2f} ms (median of 3; CG {it} iterations)")
    busy = profile_busy("fit step", step, dev, warm)

    # Card vs CPU at N = 2·10⁴: three steps on the same probes.
    cpu = torch.device("cpu")
    def small_fit(d):
        graph_d, tx, m, yy, pr = fit_problem(E2E, d)
        return fit_chunk(tx, m, yy, graph_d.n_nodes, pr, 3, d)[0]

    card, host = small_fit(dev), small_fit(cpu)
    for name, a, b in (
            ("log_beta", card["mod"]["log_beta"], host["mod"]["log_beta"]),
            ("log_sigma_f", card["mod"]["log_sigma_f"], host["mod"]["log_sigma_f"]),
            ("log_sigma_n", card["log_sigma_n"], host["log_sigma_n"])):
        err, rel = rel_err(a.cpu().reshape(1), b.reshape(1))
        expect(rel <= E2E_RTOL, f"fit card vs CPU {name}: rel {rel:.2e}")
        print(f"[fit] card vs CPU after 3 steps at N={E2E['n_nodes']}: {name} "
              f"max abs {err:.3e} (rel {rel:.2e})")
    return dict(counts=counts, warm_step_s=warm, cg_iters=it, busy=busy,
                trace_x=trace_x, mod=mod, y=y, probes=probes,
                history=res.history)


def serving_problem(cfg: dict, dev):
    """Graph, walk config, f, σ², walk seed and the node sets of the
    serving phase, from seeds."""
    import torch

    from repro_torch.core import modulation, walks
    from repro_torch.graphs import generators, signals

    n = cfg["n_nodes"]
    graph = generators.ring(n, k=SERVE["ring_k"], device=dev)
    wcfg = walks.WalkConfig(SERVE["n_walkers"], SERVE["p_halt"], SERVE["l_max"])
    mod = modulation.diffusion(l_max=SERVE["l_max"])
    f = mod(mod.init(device=dev))
    seed = walks.walk_seed(torch.Generator().manual_seed(9))
    rng = np.random.default_rng(4)
    truth = signals.smooth_periodic_ring(n, seed=1)
    obs = rng.choice(n, SERVE["n_ingest"] + SERVE["n_observe"], replace=False)
    y = (truth[obs] + 0.1 * rng.standard_normal(len(obs))).astype(np.float32)
    nodes = dict(
        moments=rng.choice(n, SERVE["n_moments"], replace=False),
        engine=rng.choice(n, SERVE["n_engine"], replace=False),
        cand=rng.choice(n, SERVE["n_cand"], replace=False),
    )
    return graph, wcfg, f, seed, obs.astype(np.int32), y, nodes


def serving_calls(cfg: dict, dev):
    """The serving path as (label, zero-argument call) pairs, in order."""
    import torch

    from repro_torch import serving

    graph, wcfg, f, seed, obs, y, nodes = serving_problem(cfg, dev)
    s2 = SERVE["sigma_n2"]
    empty = serving.init_state(graph, seed, f, s2, SERVE["capacity"], wcfg)
    st = {}
    m0 = SERVE["n_ingest"]

    def ingest():
        st["ingested"] = serving.ingest(empty, obs[:m0], y[:m0])
        return st["ingested"]

    def observe3():
        s = st["ingested"]
        for i in range(m0, m0 + SERVE["n_observe"]):
            s = serving.observe(s, int(obs[i]), float(y[i]))
        st["state"] = s
        return s

    def moments():
        return serving.posterior_moments(
            st["state"], torch.from_numpy(nodes["moments"]).to(dev))

    def engine():
        loop = serving.GPServeLoop(st["state"], batch=SERVE["batch"])
        reqs = [serving.GPRequest(nodes=nodes["engine"][i:i + SERVE["req"]])
                for i in range(0, SERVE["n_engine"], SERVE["req"])]
        return loop.run(reqs)

    def draw():
        return serving.thompson_draw(st["state"], nodes["cand"],
                                     torch.Generator(device=dev).manual_seed(1))

    def refit_alpha():
        return serving.refit_alpha(st["state"], f=f * 1.1, sigma_n2=s2 * 1.2,
                                   return_diagnostics=True)

    calls = [("ingest", ingest), ("observe x3", observe3),
             ("posterior_moments", moments), ("GPServeLoop.run", engine),
             ("thompson_draw", draw), ("refit_alpha", refit_alpha)]
    return calls, st, (empty, obs, y, nodes)


def run_serving(cfg: dict, dev, timings: dict | None = None) -> dict:
    calls, st, extra = serving_calls(cfg, dev)
    outs = {}
    for label, fn in calls:
        before = counts_now()
        out, wall, peak = timed_call(fn, dev)
        outs[label] = out
        if timings is not None:
            after = counts_now()
            timings[label] = dict(s=wall, max_mem=peak, launches={
                k: after[k] - before[k] for k in after if after[k] != before[k]})
    return dict(outs=outs, st=st, calls=calls, extra=extra)


def check_serving(run: dict, cfg: dict, label: str) -> None:
    import torch

    from repro_torch import serving

    outs, st = run["outs"], run["st"]
    empty, obs, y, nodes = run["extra"]
    s = st["state"]
    m = SERVE["n_ingest"] + SERVE["n_observe"]
    expect(int(s.count) == m and int(s.rejected) == 0 and int(s.overflow) == 0,
           f"{label}: state count {int(s.count)} / flags")
    scratch = serving.ingest(empty, obs, y)
    for name in ("chol", "alpha"):
        err, rel = rel_err(getattr(s, name), getattr(scratch, name))
        expect(rel <= E2E_RTOL, f"{label}: incremental vs ingest {name} rel {rel:.2e}")
    mean, var = outs["posterior_moments"]
    expect(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()
                and (var >= 0).all()), f"{label}: moments not finite / negative var")
    reqs = outs["GPServeLoop.run"]
    expect(all(r.done for r in reqs), f"{label}: unanswered engine requests")
    em = np.concatenate([r.mean for r in reqs])
    ev = np.concatenate([r.var for r in reqs])
    wm, wv = serving.posterior_moments(s, torch.from_numpy(nodes["engine"]).to(s.device))
    for a, b, what in ((em, wm, "mean"), (ev, wv, "var")):
        _, rel = rel_err(torch.from_numpy(a), b.cpu())
        expect(rel <= KERNEL_RTOL, f"{label}: engine {what} vs posterior_moments rel {rel:.2e}")
    draw = outs["thompson_draw"]
    expect(tuple(draw.shape) == (SERVE["n_cand"], 1) and bool(torch.isfinite(draw).all()),
           f"{label}: thompson draw {tuple(draw.shape)}")
    _, iters, conv = outs["refit_alpha"]
    expect(conv, f"{label}: refit_alpha did not converge ({iters} iterations)")
    print(f"[{label}] incremental (ingest {SERVE['n_ingest']} + observe x"
          f"{SERVE['n_observe']}) vs ingest of all {m}: within {E2E_RTOL:g}; "
          f"variances finite and >= 0 (min {float(var.min()):.3e}); engine == "
          f"posterior_moments; refit_alpha converged in {iters} iterations")


def phase_serving(dev) -> dict:
    import torch

    from repro_torch.serving import engine, state

    timings: dict = {}
    reset_counts()
    run = run_serving(SERVE, dev, timings)
    counts = counts_now()
    gate_counts("serving", counts, ("walk_sampler", "gram_block"))
    check_serving(run, SERVE, "serving")
    walls: dict[str, list[float]] = {label: [] for label, _ in run["calls"]}
    for _ in range(3):
        for label, fn in run["calls"]:
            walls[label].append(timed_call(fn, dev)[1])
    warm = {k: float(np.median(v)) for k, v in walls.items()}
    for label, t in timings.items():
        print(f"[serving] {label}: first call {t['s'] * 1e3:.2f} ms, warm median "
              f"{warm[label] * 1e3:.2f} ms (of 3), max_memory_allocated "
              f"{t['max_mem'] / 2**20:.0f} MiB, launches {json.dumps(t['launches'])}")
    # One serving wave (64 nodes) for the busy share.
    s = run["st"]["state"]
    wave_nodes = torch.from_numpy(run["extra"][3]["engine"][:SERVE["batch"]]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def wave():
        return engine._engine_step(s, wave_nodes, gen)

    wave()
    wave_warm = float(np.median([timed_call(wave, dev)[1] for _ in range(3)]))
    print(f"[serving] one wave of {SERVE['batch']}: warm {wave_warm * 1e3:.2f} ms")
    busy = profile_busy("serving wave", wave, dev, wave_warm)

    # Card vs CPU at N = 2·10⁴.
    small = dict(SERVE, n_nodes=20_000)
    cpu = torch.device("cpu")
    card, host = run_serving(small, dev), run_serving(small, cpu)
    check_serving(card, small, "serving-e2e-card")
    check_serving(host, small, "serving-e2e-cpu")
    a_s, b_s = card["st"]["state"], host["st"]["state"]
    q = host["extra"][3]["cand"]
    eps = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (len(q), 2)).astype(np.float32))
    pairs = [("chol", a_s.chol, b_s.chol), ("alpha", a_s.alpha, b_s.alpha)]
    for i, what in enumerate(("mean", "var")):
        pairs.append((what, card["outs"]["posterior_moments"][i],
                      host["outs"]["posterior_moments"][i]))
    pairs.append(("refit_alpha", card["outs"]["refit_alpha"][0].alpha,
                  host["outs"]["refit_alpha"][0].alpha))
    draws = []
    for st_ in (a_s, b_s):
        tq, vq, mean, v = state._cross_solve(st_, torch.from_numpy(q).to(st_.device))
        draws.append(engine._joint_draw_tail(tq, vq, mean, v, eps.to(st_.device)))
    pairs.append(("joint draw (shared normals)", draws[0], draws[1]))
    for what, a, b in pairs:
        err, rel = rel_err(a.cpu(), b)
        expect(rel <= E2E_RTOL, f"serving card vs CPU {what}: rel {rel:.2e}")
        print(f"[serving] card vs CPU at N=20000: {what} max abs {err:.3e} "
              f"(rel {rel:.2e})")
    return dict(counts=counts, timings=timings, warm=warm, state=s,
                nodes=run["extra"][3], busy=busy, wave_warm=wave_warm)


def phase_bo(dev) -> dict:
    """thompson_sampling_incremental (two refits) and the refit engine's
    chunked path at N = 10⁶ with the serving widths."""
    import torch

    from repro_torch import serving
    from repro_torch.bo import thompson
    from repro_torch.core import modulation, walks
    from repro_torch.graphs import generators, signals

    n = SERVE["n_nodes"]
    graph = generators.ring(n, k=SERVE["ring_k"], device=dev)
    wcfg = walks.WalkConfig(SERVE["n_walkers"], SERVE["p_halt"], SERVE["l_max"])
    mod = modulation.diffusion(l_max=SERVE["l_max"])
    truth = signals.smooth_periodic_ring(n, seed=1)
    f_max = float(truth.max())
    out = {}
    stamps: list[float] = []

    def cb(st):
        sync(dev)
        stamps.append(time.perf_counter())

    def loop(engine_name):
        rng = np.random.default_rng(3)

        def objective(idx):
            idx = np.asarray(idx)
            return truth[idx] + 0.1 * rng.standard_normal(len(idx))

        stamps.clear()
        stamps.append(time.perf_counter())
        if engine_name == "incremental":
            return thompson.thompson_sampling_incremental(
                graph, wcfg, mod, objective, 17, n_init=BO["n_init"],
                n_steps=BO["rounds"], refit_every=BO["refit_every"],
                refit_steps=BO["refit_steps"], noise_std=0.1, f_max=f_max,
                n_candidates=BO["n_candidates"], checkpoint_cb=cb)
        return thompson.thompson_sampling(
            None, mod, objective, 17, n_init=BO["n_init"],
            n_steps=BO["chunked_rounds"], refit_every=BO["refit_every"],
            refit_steps=BO["refit_steps"], noise_std=0.1, f_max=f_max,
            graph=graph, walk=wcfg, chunk=MAIN["chunk"], checkpoint_cb=cb)

    for engine_name in ("incremental", "refit-chunked"):
        need = (("walk_sampler", "gram_block", "khat_fused", "ell_spmv_t")
                if engine_name == "incremental"
                else ("walk_sampler", "ell_spmv", "ell_spmv_t", "khat_fused"))
        def run(engine_name=engine_name):
            return loop(engine_name)

        reset_counts()
        st, wall, peak = timed_call(run, dev)
        ms = np.diff(stamps) * 1e3
        stamps_first = list(stamps)
        counts = counts_now()
        gate_counts(f"bo {engine_name}", counts, need)
        rounds = BO["rounds"] if engine_name == "incremental" else BO["chunked_rounds"]
        x = st.x_obs
        expect(len(stamps_first) == rounds + 1 and st.iteration == rounds
               and st.count == BO["n_init"] + rounds, f"bo {engine_name}: missing round")
        expect(len(np.unique(x)) == len(x), f"bo {engine_name}: a node was picked twice")
        leaves = [st.params["log_sigma_n"], *st.params["mod"].values()]
        expect(all(bool(torch.isfinite(p).all()) for p in leaves),
               f"bo {engine_name}: non-finite hyperparameters")
        warm = float(np.median([timed_call(run, dev)[1] for _ in range(3)]))
        print(f"[bo] {engine_name}: first call {wall * 1e3:.1f} ms, ms per round "
              + ", ".join(f"{m:.1f}" for m in ms)
              + f"; warm median {warm * 1e3:.1f} ms (of 3, per round "
              + ", ".join(f"{m:.1f}" for m in np.diff(stamps) * 1e3)
              + f" in the last); max_memory_allocated {peak / 2**20:.0f} MiB; "
              + "regret " + ", ".join(f"{r:.4f}" for r in st.regret)
              + f"; sigma_n2 {float(torch.exp(2 * st.params['log_sigma_n'])):.4f}")
        out[engine_name] = dict(counts=counts, ms=ms.tolist(), regret=st.regret)

    # One non-refit incremental round (draw + append) for the busy share.
    s = serving.init_state(graph, 5, mod(mod.init(device=dev)), 0.05,
                           BO["n_init"] + 2, wcfg)
    rng = np.random.default_rng(6)
    init = rng.choice(n, BO["n_init"], replace=False)
    s = serving.ingest(s, init, truth[init].astype(np.float32))
    cand = rng.choice(n, BO["n_candidates"], replace=False).astype(np.int32)

    def bo_round():
        d = serving.thompson_draw(s, cand, torch.Generator(device=dev).manual_seed(2))
        pick = int(cand[int(torch.argmax(d[:, 0]))])
        return serving.observe_batch(s, [pick], [float(truth[pick])])

    bo_round()
    warm = float(np.median([timed_call(bo_round, dev)[1] for _ in range(3)]))
    print(f"[bo] one incremental round (draw over {BO['n_candidates']} + append): "
          f"warm {warm * 1e3:.2f} ms")
    out["busy"] = profile_busy("bo incremental round", bo_round, dev, warm)
    out["round_warm"] = warm
    return out


def solver_problem(cfg: dict, dev):
    """bench_solvers.py's operating point at its full-mode walker width:
    ring(N, k=3), T = 4√N contiguous nodes (correlated rows), diffusion
    β = 4, σ_f = 25, σ² = 1e-2, b from default_rng(N).  Returns
    (graph, wcfg, walk seed, f, train, trace_x, h, b)."""
    import math

    import torch

    from repro_torch.core import linops, modulation, walks
    from repro_torch.graphs import generators

    n = cfg["n_nodes"]
    t = min(4 * int(np.sqrt(n)), n // 4)
    graph = generators.ring(n, k=cfg["ring_k"], device=dev)
    wcfg = walks.WalkConfig(cfg["n_walkers"], cfg["p_halt"], cfg["l_max"])
    f = modulation.diffusion(l_max=cfg["l_max"])({
        "log_beta": torch.tensor(math.log(cfg["beta"]), device=dev),
        "log_sigma_f": torch.tensor(math.log(cfg["sigma_f"]), device=dev)})
    seed = walks.walk_seed(torch.Generator().manual_seed(0))
    train = torch.arange(t, dtype=torch.int32, device=dev)
    trace_x = walks.sample_walks_for_nodes(graph, train, seed, wcfg.n_walkers,
                                           wcfg.p_halt, wcfg.l_max)
    h = linops.shifted(trace_x, f, cfg["sigma_n2"], n)
    b = torch.from_numpy(np.random.default_rng(n).standard_normal(t)
                         .astype(np.float32)).to(dev)
    return graph, wcfg, seed, f, train, trace_x, h, b


def solve_strategy(pc: str, **kw):
    from repro_torch import solvers

    return solvers.SolveStrategy(tol=SOLVE["tol"], max_iters=SOLVE["max_iters"],
                                 preconditioner=pc, precond_rank=SOLVE["rank"],
                                 **kw)


def dense_logdet64(trace_x, f, sigma_n2: float, n: int) -> float:
    """log det H in float64 from the dense K̂ = Φ_xΦ_xᵀ, built from a CSR copy
    of Φ_x with torch.sparse.mm (a check only, never part of the port)."""
    import torch

    from repro_torch.core import features

    vals = features.feature_values(trace_x, f).double()
    t, k = vals.shape
    rows = torch.arange(t, device=vals.device).repeat_interleave(k)
    cols = trace_x.cols.reshape(-1).long()
    with warnings.catch_warnings():   # PyTorch's "sparse CSR is beta" notes
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals.reshape(-1),
                                    (t, n)).coalesce().to_sparse_csr()
        at = torch.sparse_coo_tensor(torch.stack([cols, rows]), vals.reshape(-1),
                                     (n, t)).coalesce().to_sparse_csr()
        khat = torch.sparse.mm(a, at).to_dense()
    h = khat + sigma_n2 * torch.eye(t, dtype=torch.float64, device=vals.device)
    sign, logabs = torch.linalg.slogdet(h)
    expect(float(sign) > 0, "dense H is not positive definite")
    return float(logabs)


def solver_calls(cfg: dict, dev, gen_device):
    """The solvers phase as (label, zero-argument call) pairs, in order;
    ``state`` keeps each call's last result."""
    import torch

    from repro_torch import solvers
    from repro_torch.core import linops, modulation
    from repro_torch.gp import mll, posterior

    graph, wcfg, seed, f, train, trace_x, h, b = solver_problem(cfg, dev)
    n = cfg["n_nodes"]
    h2 = linops.shifted(trace_x, f * 1.02, cfg["sigma_n2"], n)
    st: dict = {}

    def solve(pc, **kw):
        return lambda: solvers.solve(h, b, solve_strategy(pc, **kw))

    def build():
        return solvers.nystrom_precond(h, rank=cfg["rank"])

    def prebuilt():
        return solvers.solve(h, b, solve_strategy("nystrom"), precond=st["build"])

    def warm():
        return solvers.solve(h2, b, solve_strategy("jacobi", warm_start=True),
                             x0=st["jacobi"].x)

    def cold():
        return solvers.solve(h2, b, solve_strategy("jacobi"))

    def lml():
        return mll.exact_lml(trace_x, f, cfg["sigma_n2"], b, n,
                             torch.Generator(device=gen_device).manual_seed(5),
                             strategy=solve_strategy("nystrom"),
                             n_probes=cfg["lml_probes"],
                             slq_iters=cfg["slq_iters"])

    init = {"mod": {"log_beta": torch.log(torch.tensor(cfg["beta"], device=dev)),
                    "log_sigma_f": torch.log(torch.tensor(cfg["sigma_f"], device=dev))},
            "log_sigma_n": torch.log(torch.tensor(cfg["sigma_n2"], device=dev)) / 2}
    # MLL_DEFAULT caps CG at 256 iterations; this block needs more.
    fit_strategy = solvers.MLL_DEFAULT.with_(
        preconditioner="nystrom", precond_rank=cfg["rank"],
        max_iters=cfg["max_iters"])

    def fit():
        return mll.fit_hyperparams(
            trace_x, modulation.diffusion(l_max=cfg["l_max"]), b, n,
            torch.Generator(device=gen_device).manual_seed(11),
            steps=cfg["fit_steps"], chunk=cfg["fit_steps"],
            n_probes=cfg["fit_probes"], init_params=init, strategy=fit_strategy)

    def chunked():
        return posterior.pathwise_samples_chunked(
            graph, train, f, cfg["sigma_n2"], b,
            torch.Generator(device=gen_device).manual_seed(3), seed, wcfg,
            chunk=cfg["chunk"], n_samples=cfg["n_samples"],
            strategy=solvers.POSTERIOR_DEFAULT.with_(
                preconditioner="nystrom", precond_rank=cfg["rank"],
                max_iters=cfg["max_iters"]),
            return_diagnostics=True)

    # (label, key of the result in ``st``, call)
    calls = [("none", "none", solve("none")), ("jacobi", "jacobi", solve("jacobi")),
             ("nystrom", "nystrom", solve("nystrom")), ("auto", "auto", solve("auto")),
             ("bf16 jacobi", "bf16 jacobi", solve("jacobi", matvec_dtype="bfloat16")),
             ("bf16 nystrom", "bf16 nystrom", solve("nystrom", matvec_dtype="bfloat16")),
             ("nystrom build", "build", build),
             ("nystrom solve, prebuilt", "prebuilt", prebuilt),
             ("warm jacobi, f x 1.02", "warm", warm),
             ("cold jacobi, f x 1.02", "cold", cold),
             ("exact_lml", "lml", lml), ("fit 5 steps, nystrom", "fit", fit),
             ("pathwise_samples_chunked, nystrom", "chunked", chunked)]

    def keep(key, fn):
        def call():
            st[key] = fn()
            return st[key]
        return call

    return ([(label, key, keep(key, fn)) for label, key, fn in calls], st,
            (h, b, trace_x, f))


def check_solves(st: dict, label: str) -> None:
    """Convergence, agreement with the unpreconditioned solution (5e-3, and
    5e-2 norm-relative for bf16 payloads, as examples/solver_strategies.py
    holds them), the warm start, and a finite exact LML."""
    import torch

    x_none = st["none"].x
    for key in ("none", "jacobi", "nystrom", "auto", "bf16 jacobi",
                "bf16 nystrom", "prebuilt", "warm", "cold"):
        res = st[key]
        expect(bool(torch.all(res.converged)),
               f"{label}: solve '{key}' did not converge in {res.iters} iterations")
    pairs = [(k, "none") for k in ("jacobi", "nystrom", "auto", "prebuilt")]
    for key, ref in pairs + [("warm", "cold")]:
        x, x_ref = st[key].x, st[ref].x
        expect(torch.allclose(x, x_ref, rtol=5e-3, atol=5e-3),
               f"{label}: '{key}' differs from '{ref}' by "
               f"{float(torch.max(torch.abs(x - x_ref))):.3e}")
    for key in ("bf16 jacobi", "bf16 nystrom"):
        rel = float(torch.linalg.norm(st[key].x - x_none) / torch.linalg.norm(x_none))
        expect(rel <= 5e-2, f"{label}: '{key}' norm-relative error {rel:.3e}")
    expect(st["warm"].iters <= st["cold"].iters,
           f"{label}: warm start took {st['warm'].iters} iterations, cold "
           f"{st['cold'].iters}")
    out = st["lml"]
    expect(out["converged"] and bool(torch.isfinite(out["lml"])),
           f"{label}: exact_lml not converged or non-finite ({out})")


def _describe(key: str, res) -> str:
    if key in ("build", "lml"):
        return ""
    if key == "fit":
        return "CG iters " + "/".join(str(x["cg_iters"]) for x in res.history) + ", "
    if key == "chunked":
        return f"iters {res[1]}, "
    return f"iters {res.iters}, precond_rank {res.precond_rank}, "


def phase_solvers(dev) -> dict:
    """The Nyström/SLQ stack at N = 10⁶ on bench_solvers.py's clustered
    block: every strategy solve, a warm start, the exact LML, 5 fit steps
    and the chunked pathwise samples under "nystrom"; then card vs CPU at
    N = 2·10⁴."""
    import torch

    from repro_torch import solvers
    from repro_torch.gp import mll
    from repro_torch.solvers import nystrom

    cfg = SOLVE
    rank = cfg["rank"]
    calls, st, (h, b, trace_x, f) = solver_calls(cfg, dev, dev)
    timings = {}
    reset_counts()
    for label, key, fn in calls:
        before = counts_now()
        _, wall, peak = timed_call(fn, dev)
        after = counts_now()
        timings[key] = dict(s=wall, max_mem=peak, launches={
            k: after[k] - before[k] for k in after if after[k] != before[k]})
    counts = counts_now()
    gate_counts("solvers", counts, ("walk_sampler", "ell_spmv", "ell_spmv_t",
                                    "khat_fused", "gram_block", "woodbury_apply"))
    check_solves(st, "solvers")
    launched = lambda key, name: timings[key]["launches"].get(name, 0)  # noqa: E731
    # A Nyström solve applies M⁻¹ once at init and once per iteration; a
    # Nyström build takes one gram_block column per pivot.
    for key in ("nystrom", "bf16 nystrom", "prebuilt"):
        res = st[key]
        expect(launched(key, "woodbury_apply") == res.iters + 1,
               f"solvers: '{key}' launched woodbury_apply "
               f"{launched(key, 'woodbury_apply')} times in {res.iters} iterations")
        expect(res.precond_rank == rank, f"solvers: '{key}' rank {res.precond_rank}")
    for key in ("nystrom", "bf16 nystrom", "build"):
        expect(launched(key, "gram_block") == rank,
               f"solvers: '{key}' launched gram_block {launched(key, 'gram_block')} times")
    expect(launched("prebuilt", "gram_block") == 0,
           "solvers: the prebuilt solve rebuilt the preconditioner")
    hist = st["fit"].history
    expect(len(hist) == cfg["fit_steps"]
           and all(x["cg_converged"] and np.isfinite(x["loss"]) for x in hist),
           f"solvers: a fit step did not converge: {hist}")
    # Each fit step: one Nyström solve at R = 1 + probes, its build.
    expect(launched("fit", "woodbury_apply") == sum(x["cg_iters"] + 1 for x in hist)
           and launched("fit", "gram_block") == rank * len(hist),
           f"solvers: fit launches {timings['fit']['launches']}")
    samples, it_s, conv_s = st["chunked"]
    expect(conv_s and tuple(samples.shape) == (cfg["n_nodes"], cfg["n_samples"])
           and bool(torch.isfinite(samples).all()),
           f"solvers: chunked samples {tuple(samples.shape)} converged {conv_s}")
    expect(launched("chunked", "woodbury_apply") == it_s + 1,
           "solvers: chunked woodbury_apply launches")

    # The SLQ log-det against float64 slogdet of the dense H.
    dense = dense_logdet64(trace_x, f, cfg["sigma_n2"], cfg["n_nodes"])
    lml = st["lml"]
    slq = float(lml["logdet"])
    rel = abs(slq - dense) / abs(dense)
    expect(rel <= 0.05, f"solvers: SLQ log-det {slq:.3f} vs dense {dense:.3f} "
           f"(rel {rel:.3e})")
    print(f"[solvers] exact_lml: lml {float(lml['lml']):.3f}, datafit "
          f"{float(lml['datafit']):.3f}, SLQ log-det {slq:.3f} ({cfg['lml_probes']} "
          f"probes x {cfg['slq_iters']} iterations) vs dense float64 {dense:.3f} "
          f"(rel {rel:.3e})")
    costs = nystrom.rank_costs(h, tol=cfg["tol"])
    print("[solvers] auto scored (rank, predicted iterations, cost in "
          "unpreconditioned iterations): "
          + "; ".join(f"({r}, {it:.1f}, {c:.1f})" for r, it, c in costs)
          + f" -> rank {st['auto'].precond_rank}")
    for x in hist:
        print(f"[solvers] fit step {x['step']}: loss {x['loss']:.4f}, sigma_n2 "
              f"{x['sigma_n2']:.5f}, cg_iters {x['cg_iters']}, converged "
              f"{x['cg_converged']}")

    walls: dict[str, list[float]] = {key: [] for _, key, _ in calls}
    for _ in range(3):
        for _, key, fn in calls:
            walls[key].append(timed_call(fn, dev)[1])
    warm = {k: float(np.median(v)) for k, v in walls.items()}
    for label, key, _ in calls:
        t = timings[key]
        print(f"[solvers] {label}: {_describe(key, st[key])}first call "
              f"{t['s'] * 1e3:.1f} ms, warm median {warm[key] * 1e3:.1f} ms (of 3), "
              f"max_memory_allocated {mib(t['max_mem'])} MiB, launches "
              f"{json.dumps(t['launches'])}")
    busy = {key: profile_busy(f"solvers {label}", fn, dev, warm[key])
            for label, key, fn in calls}
    print(f"[solvers] Nyström build (rank {rank}, T = {h.shape[0]}) warm "
          f"{warm['build'] * 1e3:.1f} ms, apart from its solve "
          f"{warm['prebuilt'] * 1e3:.1f} ms ({st['prebuilt'].iters} iterations)")

    # Card vs CPU at N = 2·10⁴: the Nyström solve and exact_lml, with the
    # probes drawn from one host generator on both.
    small = dict(cfg, n_nodes=E2E["n_nodes"])
    got = []
    for d in (dev, torch.device("cpu")):
        _, _, _, f_d, _, tx_d, h_d, b_d = solver_problem(small, d)
        pc = solvers.nystrom_precond(h_d, rank=rank)
        sol = solvers.solve(h_d, b_d, solve_strategy("nystrom"), precond=pc)
        expect(bool(torch.all(sol.converged)), f"solvers e2e ({d}): not converged")
        out = mll.exact_lml(tx_d, f_d, small["sigma_n2"], b_d, small["n_nodes"],
                            torch.Generator().manual_seed(5),
                            strategy=solve_strategy("nystrom"),
                            n_probes=small["lml_probes"],
                            slq_iters=small["slq_iters"])
        got.append((sol, pc.pivots.cpu(), out))
    (s_a, p_a, l_a), (s_b, p_b, l_b) = got
    print(f"[solvers] card vs CPU at N={small['n_nodes']} (T = {len(s_b.x)}): "
          f"{int((p_a == p_b).sum())} of {len(p_b)} Nyström pivots agree (not "
          f"gated); iterations {s_a.iters} vs {s_b.iters}")
    for what, a, bb in (("nystrom solve x", s_a.x, s_b.x),
                        ("exact_lml lml", l_a["lml"], l_b["lml"]),
                        ("exact_lml logdet", l_a["logdet"], l_b["logdet"]),
                        ("exact_lml datafit", l_a["datafit"], l_b["datafit"])):
        err, rel_ = rel_err(a.cpu().reshape(-1), bb.reshape(-1))
        expect(rel_ <= E2E_RTOL, f"solvers card vs CPU {what}: rel {rel_:.2e}")
        print(f"[solvers] card vs CPU at N={small['n_nodes']}: {what} max abs "
              f"{err:.3e} (rel {rel_:.2e})")
    return dict(counts=counts, timings=timings, warm=warm, busy=busy,
                precond=st["build"], h=h, b=b, trace_x=trace_x, f=f,
                iters=st["prebuilt"].iters)


# --------------------------------------------------------------------------
# Slice 4: the LM scaffold's kernels and its serving path
# --------------------------------------------------------------------------


def bf16_err(got, want) -> tuple[float, float]:
    """(max |got − want|, that in bf16 ulps of the plain result's scale)."""
    err, _ = rel_err(got, want)
    scale = float(want.abs().max())
    return err, err / 2.0 ** (math.floor(math.log2(scale)) - 7)


def attn_inputs(dev, shape, dtype, seed):
    import torch

    b, h, hkv, sq, skv, d = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device=dev).to(dtype)
                 for s in ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


def tc_expected(dtype, d: int) -> bool:
    """The routing rule for aligned inputs: bf16 with D a multiple of 8 up
    to 256 runs on the tensor cores, everything else on the CUDA cores."""
    import torch

    return dtype == torch.bfloat16 and d % 8 == 0 and d <= 256


def attn_case(dev, shape, kw, dtype, seed, qkv=None) -> tuple[float, float]:
    """One flash_attention call against mha_ref on the card: (max abs err,
    rel err for f32 or bf16 ulps of scale).  Gates the instance it took:
    the tensor cores where the rule says so for aligned inputs (the CUDA
    cores for the misaligned views that ``qkv`` may pass)."""
    import torch

    from repro_torch.kernels.flash_attention import ops, ref

    q, k, v = attn_inputs(dev, shape, dtype, seed) if qkv is None else qkv
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(q, k, v, **kw)
    sync(dev)
    want_tc = tc_expected(dtype, shape[-1]) and ops.aligned(q, k, v)
    inst = ops.TENSOR_CORE if want_tc else ops.CUDA_CORE
    expect(ops.LAUNCHES[inst] == before[inst] + 1
           and ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1,
           f"flash_attention {shape} {kw} {dtype}: expected one {inst} launch")
    want = ref.mha_ref(q, k, v, **kw)
    expect(got.dtype == dtype and got.shape == want.shape,
           f"flash_attention {shape} {kw}: {got.dtype} {tuple(got.shape)}")
    if dtype == torch.float32:
        err, rel = rel_err(got, want)
        expect(rel <= ATTN_RTOL, f"flash_attention {shape} {kw} f32: rel {rel:.2e}")
    else:
        err, rel = bf16_err(got, want)
        expect(rel <= BF16_ULPS, f"flash_attention {shape} {kw} bf16: {rel:.2f} ulps")
    return err, rel


def check_flash_cases(dev) -> None:
    """flash_attention against its plain version: the JAX kernel tests' nine
    cases and the LM path's shapes, float32 and bf16."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    before = dict(ops.LAUNCHES)
    for i, (shape, kw) in enumerate(ATTN_CASES):
        for dt in (torch.float32, torch.bfloat16):
            worst[dt] = max(worst[dt], attn_case(dev, shape, kw, dt, 100 + i)[1])
    # Strided views of [B, S, H, D] projections, and views whose base is 2
    # bytes off 16 (a head-dim slice), which the rule sends to the CUDA cores.
    for i, (b, h, hkv, s, d) in enumerate(((2, 8, 2, 300, 80), (1, 4, 4, 200, 128))):
        gen = torch.Generator(device=dev).manual_seed(200 + i)
        q, k, v = (torch.randn((b, s, n, d + 8), generator=gen, device=dev)
                   .to(torch.bfloat16).transpose(1, 2) for n in (h, hkv, hkv))
        for off in (0, 1):
            views = tuple(t[..., off:off + d] for t in (q, k, v))
            err = attn_case(dev, (b, h, hkv, s, s, d), dict(window=128),
                            torch.bfloat16, 0, qkv=views)[1]
            worst[torch.bfloat16] = max(worst[torch.bfloat16], err)
    n = {k: ops.LAUNCHES[k] - before[k] for k in (ops.TENSOR_CORE, ops.CUDA_CORE)}
    print(f"[parity] flash_attention matches mha_ref in {2 * len(ATTN_CASES) + 4} "
          f"cases (the JAX tests' nine and the LM path's shapes, f32 and bf16; "
          f"strided and misaligned bf16 views): f32 rel "
          f"{worst[torch.float32]:.2e} (limit {ATTN_RTOL:g}), bf16 "
          f"{worst[torch.bfloat16]:.2f} ulps of scale (limit {BF16_ULPS}); "
          f"launches by instance {json.dumps(n)}")


def check_rmsnorm_cases(dev) -> None:
    """rmsnorm against its plain version: the JAX tests' cases and the LM
    path's rows (prefill 1024 and 4608, decode batch 4) at d_model 2560."""
    import torch

    from repro_torch.kernels.rmsnorm import ops, ref

    shapes = [(8, 64), (100, 256), (33, 128), (224, 96), (4608, 2560),
              (1024, 2560), (4, 2560), (1, 2560), (3, 5120), (5, 2048),
              (2, 3840), (6, 4096), (7, 4608), (37, 2566), (0, 2560)]
    gen = torch.Generator(device=dev).manual_seed(21)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for m, d in shapes:
        x = 3 * torch.randn((m, d), generator=gen, device=dev)
        s = 0.1 * torch.randn((d,), generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            got = ops.apply(x.to(dt), s)
            want = ref.rmsnorm_ref(x.to(dt), s)
            expect(got.dtype == dt and got.shape == (m, d),
                   f"rmsnorm [{m},{d}] returns {got.dtype} {tuple(got.shape)}")
            if m == 0:
                continue
            if dt == torch.float32:
                err = rel_err(got, want)[1]
                expect(err <= NORM_RTOL, f"rmsnorm [{m},{d}] f32: rel {err:.2e}")
            else:
                err = bf16_err(got, want)[1]
                expect(err <= BF16_ULPS, f"rmsnorm [{m},{d}] bf16: {err:.2f} ulps")
            worst[dt] = max(worst[dt], err)
    x3 = torch.randn((2, 17, 64), generator=gen, device=dev)
    z = torch.zeros(64, device=dev)
    expect(rel_err(ops.apply(x3, z), ref.rmsnorm_ref(x3, z))[1] <= NORM_RTOL,
           "rmsnorm 3-D input")
    # A row base one element off 16 bytes (the scalar instance).
    flat = torch.randn(1 + 9 * 2560, generator=gen, device=dev).to(torch.bfloat16)
    xu, su = flat[1:].view(9, 2560), 0.1 * torch.randn(2560, generator=gen, device=dev)
    err = bf16_err(ops.apply(xu, su), ref.rmsnorm_ref(xu, su))[1]
    expect(err <= BF16_ULPS, f"rmsnorm unaligned base: {err:.2f} ulps")
    print(f"[parity] rmsnorm matches rmsnorm_ref at {len(shapes)} shapes (M = 0 "
          f"to 4608, every config width, D = 2566), a 3-D input and an "
          f"unaligned base: f32 rel {worst[torch.float32]:.2e} (limit "
          f"{NORM_RTOL:g}), bf16 {worst[torch.bfloat16]:.2f} ulps of scale "
          f"(limit {BF16_ULPS})")


def check_lm_kernels(dev) -> None:
    check_rmsnorm_cases(dev)
    check_flash_cases(dev)


def serve_shim(real, dev, calls: list):
    """``real`` (the models.model module) with prefill and decode_step
    wrapped: each call is timed (host clock ending in a synchronize) and
    records its kernel launches and whether its logits are finite."""
    import types

    import torch

    def wrap(kind, fn, tok_arg):
        def inner(*args, **kw):
            c0 = counts_now()
            sync(dev)
            t0 = time.perf_counter()
            logits, cache = fn(*args, **kw)
            sync(dev)
            wall = time.perf_counter() - t0
            c1 = counts_now()
            calls.append(dict(kind=kind, s=wall, tokens=args[tok_arg].shape[1],
                              finite=bool(torch.isfinite(logits).all()),
                              launches={k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}))
            return logits, cache
        return inner

    return types.SimpleNamespace(
        prefill=wrap("prefill", real.prefill, 2),
        decode_step=wrap("decode", real.decode_step, 3),
        init_cache=real.init_cache, tree_map=real.tree_map)


def lm_check(dev) -> None:
    """Full width cut to LM_CHECK["layers"] layers, f32 activations and
    cache, window LM_CHECK["window"]: teacher-forced prefill + decode against
    forward on the card, and the same run on the card against the CPU."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import LayerSpec, model

    c = LM_CHECK
    cfg = dataclasses.replace(
        configs.get_config(LM["arch"]), dtype="float32", cache_dtype="float32",
        stages=((c["layers"], (LayerSpec(kind="attn", window=c["window"]),)),))
    n = c["prompt"] + c["steps"]
    params = model.init_params(cfg, seed=LM["seed"] + 1, device=dev)
    tok = torch.from_numpy(np.random.default_rng(LM["seed"] + 1).integers(
        0, cfg.vocab_size, (1, n))).long()

    def run(params, device):
        t = tok.to(device)
        first, cache = model.prefill(params, cfg, t[:, :c["prompt"]], max_len=n)
        outs = [first]
        for i in range(c["prompt"], n):
            lg, cache = model.decode_step(params, cache, cfg, t[:, i:i + 1], i)
            outs.append(lg[:, 0])
        return torch.stack(outs, 1)    # logits at positions prompt−1 .. n−1

    card = run(params, dev)
    full, _ = model.forward(params, cfg, tok.to(dev))
    err, rel = rel_err(card, full[:, c["prompt"] - 1:])
    expect(rel <= c["rtol"], f"lm decode vs forward on the card: rel {rel:.2e}")
    print(f"[lm] {c['layers']} layers at full width, f32, window {c['window']}: "
          f"prefill({c['prompt']}) + {c['steps']} decode steps vs forward on the "
          f"card max abs {err:.3e} (rel {rel:.2e}, limit {c['rtol']:g})")
    host = run(model.tree_map(lambda a: a.cpu(), params), torch.device("cpu"))
    err, rel = rel_err(card.cpu(), host)
    expect(rel <= c["rtol"], f"lm card vs CPU: rel {rel:.2e}")
    print(f"[lm] the same run on the card (kernels) vs the CPU (plain versions): "
          f"max abs {err:.3e} (rel {rel:.2e}, limit {c['rtol']:g}); greedy tokens "
          f"card {card[0].argmax(-1).tolist()} cpu {host[0].argmax(-1).tolist()}")


def phase_lm(dev) -> dict:
    """ServeLoop on h2o-danube-1.8b at its published width: the waves of LM
    (4 prompts of 1024 tokens, then 4 of 4608, past the 4096 window), 32
    greedy tokens each, with launch counts set to 0 just before the run."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve
    from repro_torch.models import model

    cfg = configs.get_config(LM["arch"])
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=LM["seed"], device=dev)
    n_params = sum(t.numel() for t in model.tree_leaves(params))
    loop = serve.ServeLoop(cfg, params, batch=LM["batch"], max_len=LM["max_len"])
    del params
    torch.cuda.empty_cache()
    sync(dev)
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
          f"window {cfg.stages[0][1][0].window}, {n_params / 1e9:.3f} B params "
          f"(seed {LM['seed']}), {cfg.dtype}; init + cast "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(LM["seed"])
    reqs = [serve.Request(prompt=rng.integers(0, cfg.vocab_size, s).astype(np.int32),
                          max_new_tokens=LM["new_tokens"])
            for n, s in LM["waves"] for _ in range(n)]
    calls: list = []
    real = serve.model
    serve.model = serve_shim(real, dev, calls)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        loop.run(reqs)
        sync(dev)
        run_s = time.perf_counter() - t0
        counts = counts_now()
    finally:
        serve.model = real
    peak = torch.cuda.max_memory_allocated(dev)
    tc = flash_ops.TENSOR_CORE
    gate_counts("lm", counts, ("flash_attention", tc, "rmsnorm"))
    norms = 2 * cfg.n_layers + 1
    pre = [c for c in calls if c["kind"] == "prefill"]
    dec = [c for c in calls if c["kind"] == "decode"]
    expect(all(len(r.generated) == LM["new_tokens"] for r in reqs),
           f"lm: generated {[len(r.generated) for r in reqs]}")
    expect(len(pre) == len(reqs), f"lm: {len(pre)} prefills for {len(reqs)} requests")
    expect(all(c["finite"] for c in calls), "lm: non-finite logits")
    for c in pre:   # every layer's attention on the tensor-core instance
        expect(c["launches"].get("flash_attention") == cfg.n_layers
               and c["launches"].get(tc) == cfg.n_layers
               and c["launches"].get("rmsnorm") == norms,
               f"lm: a prefill launched {c['launches']}")
    for c in dec:
        expect("flash_attention" not in c["launches"]
               and c["launches"].get("rmsnorm") == norms,
               f"lm: a decode step launched {c['launches']}")
    expect(counts["flash_attention"] == cfg.n_layers * len(reqs)
           and counts[tc] == counts["flash_attention"],
           f"lm: flash_attention launched {counts['flash_attention']} times, "
           f"{counts[tc]} on the tensor cores")
    out = dict(counts=counts, run_s=run_s, peak=peak, prefill={}, decode={})
    # Each wave drains before the next is admitted: the calls come as the
    # wave's prefills, then its decode steps.
    start = 0
    for n, s in LM["waves"]:
        wave = calls[start:start + n + LM["new_tokens"] - 1]
        start += len(wave)
        fills = [c["s"] for c in wave if c["kind"] == "prefill"]
        steps = [c["s"] for c in wave if c["kind"] == "decode"]
        expect(len(fills) == n and all(c["tokens"] == s for c in wave[:n]),
               f"lm: wave of {s} tokens out of order")
        step = float(np.median(steps))
        out["prefill"][s] = dict(first=fills[0], warm=float(np.median(fills[1:])))
        out["decode"][s] = step
        print(f"[lm] prompts of {s}: prefill first {fills[0] * 1e3:.1f} ms, warm "
              f"median {out['prefill'][s]['warm'] * 1e3:.1f} ms (of {n - 1}); decode "
              f"{len(steps)} steps at batch {n}: median {step * 1e3:.2f} ms/step, "
              f"{n / step:.1f} tokens/s")
    print(f"[lm] served {len(reqs)} requests x {LM['new_tokens']} tokens in "
          f"{run_s:.2f} s; max_memory_allocated {peak / 2**20:.0f} MiB; launches "
          f"per prefill {json.dumps(pre[0]['launches'])}, per decode step "
          f"{json.dumps(dec[0]['launches'])}")
    # Device busy share of one decode step, and of one prefill at each
    # prompt length (a wave's first request).
    token = torch.zeros((LM["batch"], 1), dtype=torch.long, device=dev)
    pos = LM["waves"][-1][1] + LM["new_tokens"]
    step = lambda: model.decode_step(loop.params, loop.cache, cfg, token, pos)  # noqa: E731
    warm = float(np.median([timed_call(step, dev)[1] for _ in range(5)]))
    out["busy_decode"] = profile_busy(f"lm decode step (batch {LM['batch']})",
                                      step, dev, warm)
    out["busy_prefill"] = {}
    first = 0
    for n, s in LM["waves"]:
        prompt = torch.as_tensor(reqs[first].prompt[None], device=dev).long()
        first += n
        fill = lambda: model.prefill(loop.params, cfg, prompt, max_len=LM["max_len"])  # noqa: E731
        warm = float(np.median([timed_call(fill, dev)[1] for _ in range(2)]))
        out["busy_prefill"][s] = profile_busy(f"lm prefill ({s} tokens)", fill,
                                              dev, warm)
    del loop, calls, step, fill
    torch.cuda.empty_cache()
    lm_check(dev)
    return out


# --------------------------------------------------------------------------
# Slice 9: the paper's baselines, SVGP classification, the JLT solver and
# the observability layer
# --------------------------------------------------------------------------


def check_baseline_kernels(dev) -> dict:
    """The shapes the baselines give the kernels that earlier paths never
    did: ell_spmv at WIDE_SPMV (R past 32 float4 lanes: column chunks) and
    walk_sampler at the SVGP trace (K = 3000) and the baselines' trace
    (K = 1100), each against its plain version (ell_spmv within 1e-5 of
    scale and bit-equal over two calls; walks bit-equal for every scheme)
    and timed.  Comparison launches only: no path runs here."""
    import torch

    from repro_torch.core import features, modulation, walks
    from repro_torch.graphs import generators

    spmv = []
    for n, r in WIDE_SPMV:
        graph = generators.ring(n, k=MAIN["ring_k"], device=dev)
        wcfg = walks.WalkConfig(MAIN["n_walkers"], MAIN["p_halt"], MAIN["l_max"])
        mod = modulation.diffusion(l_max=MAIN["l_max"])
        f = mod(mod.init(device=dev))
        rows = torch.from_numpy(np.sort(np.random.default_rng(0).choice(
            n, MAIN["n_train"], replace=False)).astype(np.int32)).to(dev)
        seed = walks.walk_seed(torch.Generator(device=dev).manual_seed(7))
        tx = walks.sample_walks_for_nodes(graph, rows, seed, wcfg.n_walkers,
                                          wcfg.p_halt, wcfg.l_max)
        vals = features.feature_values(tx, f).contiguous()
        u = torch.randn((n, r), generator=torch.Generator(device=dev).manual_seed(11),
                        device=dev)
        print(f"[parity] ell_spmv wide: u [{n}, {r}] is {u.numel() * 4 / 2**30:.2f} GiB")
        spmv.append(timing_spmv(dev, f"wide R={r}", vals, tx.cols, u, 10))
        del u, graph
        torch.cuda.empty_cache()
    walk = []
    g, _ = generators.community_sbm(SVGP["n_nodes"], SVGP["n_classes"],
                                    p_in=SVGP["p_in"], p_out=SVGP["p_out"],
                                    seed=0, device=dev)
    walk.append(walk_shape(dev, g, 2024, "svgp", SVGP, g.n_nodes, 10))
    g = generators.grid2d(BASE["rows"], BASE["cols"], device=dev)
    walk.append(walk_shape(dev, g, 2024, "baselines", BASE, g.n_nodes, 10))
    print(f"[parity] baselines' shapes: ell_spmv at R = "
          + ", ".join(str(x["shape"][2]) for x in spmv)
          + " within 1e-5 of scale and bit-equal twice; walk_sampler at K = "
          + ", ".join(str(x["shape"][1]) for x in walk)
          + " bit-equal to the plain version for every scheme")
    return dict(ell_spmv=spmv, walk_sampler=walk)


def baselines_problem(dev, rows: int, cols: int):
    """grid2d(rows, cols), a ground truth drawn from the exact diffusion
    kernel through the port's own eigendecomposition, y = V·(√spec ⊙ z)
    (a float64 host Cholesky of the float32 kernel need not be positive
    definite at this N), and T = N/4 observations with noise BASE["noise"];
    z, the training nodes and the noise from numpy default_rng(0)."""
    import torch

    from repro_torch.core import kernels_exact
    from repro_torch.graphs import generators

    g = generators.grid2d(rows, cols, device=dev)
    n = g.n_nodes
    evals, evecs = kernels_exact.laplacian_eigh(g)
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    spec = torch.exp(-BASE["beta"] * torch.clamp(evals, min=0.0))
    ytrue = (evecs @ (torch.sqrt(spec) * z)).cpu().numpy()
    train = rng.choice(n, n // 4, replace=False)
    y = (ytrue[train] + BASE["noise"] * rng.standard_normal(len(train))).astype(np.float32)
    test = np.setdiff1d(np.arange(n), train)
    return g, ytrue, train, test, y


def phase_baselines(dev) -> dict:
    """The paper's comparison (exact GP, O(N³), against GRFs) at
    grid2d(64, 64): wall, peak memory, test RMSE and NLPD of each, the
    device idle share of the GRF fit and posterior, the fused K̂ at the
    fit's CG shape (K = 1100), the exact path card vs CPU at N = 400, and
    the wind twin at its defaults."""
    import argparse

    import torch

    from repro_torch.core import features, modulation, walks
    from repro_torch.examples import quickstart, wind_interpolation
    from repro_torch.gp import exact, mll, posterior
    from repro_torch.kernels.ell_spmv import ops as eops
    from repro_torch.kernels.ell_spmv import ref as eref

    g, ytrue, train, test, y = baselines_problem(dev, BASE["rows"], BASE["cols"])
    n, t = g.n_nodes, len(train)
    print(f"[baselines] grid2d({BASE['rows']}, {BASE['cols']}): N = {n}, T = {t}, "
          f"noise {BASE['noise']}; ground truth y = V·(sqrt(exp(-{BASE['beta']} "
          "λ)) ⊙ z) from the port's eigendecomposition")
    train_t, y_t = torch.as_tensor(train, device=dev), torch.as_tensor(y, device=dev)
    out = {}

    # The exact GP: quickstart's 150-step fit of the exact diffusion kernel,
    # then the Cholesky posterior.
    reset_counts()
    exact_fn = lambda: quickstart.exact_gp(g, train, y, ytrue, test,   # noqa: E731
                                           steps=BASE["exact_steps"])
    (p_ex, rmse_ex, nlpd_ex), wall, peak = timed_call(exact_fn, dev)
    _, warm, warm_peak = timed_call(exact_fn, dev)
    counts = counts_now()
    expect(not any(counts.values()),
           f"the exact path launched a kernel of the port: {counts}")
    expect(math.isfinite(rmse_ex) and math.isfinite(nlpd_ex),
           f"exact GP: non-finite scores {rmse_ex} {nlpd_ex}")
    print(f"[baselines] exact GP: test RMSE {rmse_ex:.4f}, NLPD {nlpd_ex:.4f}; "
          f"fit ({BASE['exact_steps']} steps, one eigh) + Cholesky posterior: first "
          f"{wall * 1e3:.1f} ms, warm {warm * 1e3:.1f} ms, max_memory_allocated "
          f"{mib(peak)} MiB; beta {float(torch.exp(p_ex['log_beta'])):.3f}; dense "
          "torch only (no kernel of the port launched)")
    out["exact"] = dict(rmse=rmse_ex, nlpd=nlpd_ex, first_s=wall, warm_s=warm,
                        peak=peak)

    # The GRF-GP: quickstart's walks, the 80-step LML fit and 64 pathwise
    # samples.
    reset_counts()
    mod = modulation.learnable(l_max=BASE["l_max"])
    seed = walks.walk_seed(torch.Generator().manual_seed(0))
    st = {}

    def sample():
        st["trace"] = walks.sample_walks(g, seed, BASE["n_walkers"], BASE["p_halt"],
                                         BASE["l_max"])
        st["tx"] = features.take_rows(st["trace"], train_t)
        return st["trace"]

    def fit():
        st["fit"] = mll.fit_hyperparams(
            st["tx"], mod, y_t, n, torch.Generator(device=dev).manual_seed(1),
            steps=BASE["fit_steps"], lr=BASE["lr"])
        return st["fit"]

    def draw():
        p = st["fit"].params
        with torch.no_grad():
            return posterior.pathwise_samples(
                st["trace"], train_t, mod(p["mod"]), mll.noise_var(p), y_t,
                torch.Generator(device=dev).manual_seed(2),
                n_samples=BASE["n_samples"], return_diagnostics=True)

    timings = {}
    for label, fn in (("sample_walks", sample), ("fit_hyperparams", fit),
                      ("pathwise_samples", draw)):
        res, wall, peak = timed_call(fn, dev)
        timings[label] = dict(first_s=wall, peak=peak)
    counts = counts_now()
    gate_counts("baselines", counts, ("walk_sampler", "khat_fused", "ell_spmv",
                                      "ell_spmv_t"))
    samples, iters, conv = res
    s2 = mll.noise_var(st["fit"].params).detach()
    mean, var = posterior.predictive_moments_from_samples(samples)
    rmse, nlpd = quickstart.scores(ytrue, test, mean, var + s2)
    hist = st["fit"].history
    expect(all(h["cg_converged"] for h in hist) and conv,
           "baselines: a GRF solve did not converge")
    expect(math.isfinite(rmse) and math.isfinite(nlpd),
           f"GRF-GP: non-finite scores {rmse} {nlpd}")
    for label, fn in (("fit_hyperparams", fit), ("pathwise_samples", draw)):
        timings[label]["warm_s"] = timed_call(fn, dev)[1]
    for label, fn in (("fit_hyperparams", fit), ("pathwise_samples", draw)):
        timings[label]["busy"] = profile_busy(f"baselines GRF {label}", fn, dev,
                                              timings[label]["warm_s"])
    for label, tm in timings.items():
        print(f"[baselines] GRF {label}: first {tm['first_s'] * 1e3:.1f} ms"
              + (f", warm {tm['warm_s'] * 1e3:.1f} ms" if "warm_s" in tm else "")
              + f", max_memory_allocated {mib(tm['peak'])} MiB")
    print(f"[baselines] GRF-GP: test RMSE {rmse:.4f}, NLPD {nlpd:.4f} (exact GP "
          f"{rmse_ex:.4f}, {nlpd_ex:.4f}: ratio {rmse / rmse_ex:.3f}); fit's last "
          f"step: {json.dumps(hist[-1])}; posterior CG {iters} iterations")
    expect(rmse <= 1.5 * rmse_ex,
           f"GRF-GP RMSE {rmse:.4f} beyond 1.5x the exact GP's {rmse_ex:.4f}")
    out["grf"] = dict(rmse=rmse, nlpd=nlpd, timings=timings, counts=counts)

    # The fused K̂ at the fit's CG shape: K̂_xx V over [T, 1100], R = 1 + 8
    # probes, through the training trace's column index.
    tx, f = st["tx"], mod(st["fit"].params["mod"]).detach()
    vx = features.feature_values(tx, f).contiguous()
    cx = tx.cols.contiguous()
    k = vx.shape[1]
    v = torch.randn((t, 9), generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev)
    idx = column_index_timed(tx, n, "baselines fit")
    kern = lambda: eops.khat_fused_raw(vx, cx, vx, cx, v, n, idx)  # noqa: E731
    got = kern()
    err, rel = rel_err(got, eref.khat_matvec_ref(vx, cx, vx, cx, v, n))
    expect(rel <= KERNEL_RTOL, f"khat_fused at the baselines' CG shape: rel {rel:.2e}")
    expect(torch.equal(got, kern()), "khat_fused baselines' CG shape: two calls differ")
    nnz = int((vx != 0).sum())
    ms, eager = graph_ms(kern, 100), cuda_ms(kern, 50)
    pms = cuda_ms(lambda: eref.khat_matvec_ref(vx, cx, vx, cx, v, n), 10)
    ax, ax_t = csr(vx, cx, n), csr(vx, cx, n, transpose=True)
    lib = cuda_ms(lambda: torch.sparse.mm(ax, torch.sparse.mm(ax_t, v)), 20)
    b = bound(t * k * 8 + 2 * t * 9 * 4, 4 * nnz * 9)
    print(f"[timing] khat_fused at the baselines' CG shape [{t}, {k}], R = 9: kernel "
          f"{ms:.4f} ms (graph; eager loop {eager:.4f} ms), plain {pms:.4f} ms, "
          f"library {lib:.4f} ms, bound {b[0] * 1e3:.3f} us ({b[1]}), max_abs_err "
          f"{err:.3e} (rel {rel:.2e})")
    out["khat_shape"] = dict(shape=[t, k, t, k, 9], dtype="torch.float32", ms=ms,
                             eager_ms=eager, plain_ms=pms, bound_ms=b[0],
                             bound_by=b[1], max_abs_err=err, library_ms=lib)
    del st, vx, ax, ax_t
    torch.cuda.empty_cache()

    # The exact path on the card against the CPU at N = 400 (quickstart's
    # grid): the same observations, both devices' eigendecompositions.
    from repro_torch.graphs import generators

    _, _, trc, _, ycc = baselines_problem(torch.device("cpu"), 20, 20)
    res = {}
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        gd = generators.grid2d(20, 20, device=d)
        tr_d, y_d = torch.as_tensor(trc, device=d), torch.as_tensor(ycc, device=d)
        p, kf = exact.fit_exact_diffusion(gd, tr_d, y_d, steps=BASE["exact_steps"])
        res[key] = exact.cholesky_posterior(kf, tr_d, y_d,
                                            torch.exp(2 * p["log_sigma_n"]))
    for i, name in enumerate(("mean", "var")):
        e, r = rel_err(res["card"][i].cpu(), res["cpu"][i])
        expect(r <= E2E_RTOL, f"exact GP card vs CPU at N = 400: {name} rel {r:.2e}")
        print(f"[baselines] exact GP card vs CPU at N = 400: {name} max abs {e:.3e} "
              f"(rel {r:.2e})")

    # The wind twin at its defaults (2000 nodes, both modulations).
    reset_counts()
    t0 = time.perf_counter()
    wind = wind_interpolation.run(argparse.Namespace(nodes=2000, walkers=100,
                                                     device=str(dev)))
    sync(dev)
    for name, (r, nl) in wind.items():
        expect(math.isfinite(r) and math.isfinite(nl), f"wind {name}: non-finite")
    print(f"[baselines] wind twin (2000 nodes): "
          + "; ".join(f"{k} RMSE {r:.4f} NLPD {nl:.4f}" for k, (r, nl) in wind.items())
          + f"; {time.perf_counter() - t0:.1f} s; launches {json.dumps(counts_now())}")
    out["wind"] = wind
    out["counts"] = {kk: out["grf"]["counts"][kk] + counts_now()[kk]
                     for kk in out["grf"]["counts"]}
    return out


def ridge_accuracy(k_full, labels, train, test, n_classes: int) -> float:
    """bench_classification.py's exact-kernel baseline: kernel ridge on the
    one-hot labels (ridge 0.05), argmax of the test predictions."""
    import torch

    k_xx = k_full[train][:, train]
    k_tx = k_full[test][:, train]
    onehot = torch.nn.functional.one_hot(labels[train], n_classes).float()
    alpha = torch.linalg.solve(
        k_xx + 0.05 * torch.eye(len(train), device=k_full.device), onehot)
    pred = torch.argmax(k_tx @ alpha, dim=1)
    return float(torch.mean((pred == labels[test]).float()))


def phase_svgp(dev) -> dict:
    """bench_classification.py's full-mode SVGP on the card: accuracy, wall
    per step and the device idle share of the steps, beside the two
    exact-kernel classifiers."""
    import torch

    from repro_torch.core import kernels_exact, modulation, walks
    from repro_torch.gp import variational
    from repro_torch.graphs import generators

    c = SVGP
    g, labels_np = generators.community_sbm(c["n_nodes"], c["n_classes"],
                                            p_in=c["p_in"], p_out=c["p_out"],
                                            seed=0, device=dev)
    n = g.n_nodes
    labels = torch.as_tensor(np.asarray(labels_np), dtype=torch.int64, device=dev)
    rng = np.random.default_rng(0)
    perm = rng.permutation(n)
    split = int(0.8 * n)
    train = torch.from_numpy(perm[:split]).to(dev)
    test = torch.from_numpy(perm[split:]).to(dev)
    eig = kernels_exact.laplacian_eigh(g)
    acc_diff = ridge_accuracy(kernels_exact.diffusion_kernel(g, beta=2.0, eig=eig),
                              labels, train, test, c["n_classes"])
    acc_mat = ridge_accuracy(kernels_exact.matern_kernel(g, nu=1.5, kappa=1.0, eig=eig),
                             labels, train, test, c["n_classes"])
    inducing = torch.from_numpy(rng.choice(n, c["n_inducing"], replace=False)).to(dev)

    reset_counts()
    mod = modulation.learnable(l_max=c["l_max"])
    seed = walks.walk_seed(torch.Generator().manual_seed(0))
    st = {}

    def sample():
        st["trace"] = walks.sample_walks(g, seed, c["n_walkers"], c["p_halt"],
                                         c["l_max"])

    def fit(steps=c["steps"]):
        st["params"] = variational.fit_svgp(
            st["trace"], mod, inducing, train, labels[train], n, c["n_classes"],
            generator=torch.Generator(device=dev).manual_seed(1), steps=steps,
            lr=c["lr"], n_mc=c["n_mc"])

    _, t_walk, _ = timed_call(sample, dev)
    _, wall, peak = timed_call(fit, dev)
    pred = variational.predict_classes(st["params"], st["trace"], mod, inducing,
                                       test, n)
    acc = float(torch.mean((pred == labels[test]).float()))
    counts = counts_now()
    gate_counts("svgp", counts, ("walk_sampler",))
    chance = 1.0 / c["n_classes"]
    expect(acc >= 2 * chance, f"svgp accuracy {acc:.3f} below twice chance {chance:.3f}")
    short = lambda: fit(10)   # noqa: E731
    warm10 = timed_call(short, dev)[1]
    busy = profile_busy("svgp 10 steps", short, dev, warm10)
    print(f"[svgp] SBM({n}, {c['n_classes']}), K = {st['trace'].slots}, "
          f"{c['n_inducing']} inducing, {c['steps']} steps: accuracy {acc:.4f} "
          f"(chance {chance:.4f}); exact diffusion (beta 2) {acc_diff:.4f}, exact "
          f"Matérn (nu 1.5, kappa 1) {acc_mat:.4f}; walks {t_walk * 1e3:.1f} ms; fit "
          f"{wall:.2f} s ({wall / c['steps'] * 1e3:.2f} ms a step; 10 warm steps "
          f"{warm10 / 10 * 1e3:.2f} ms a step), max_memory_allocated {mib(peak)} MiB; "
          "the kernel blocks are dense products (no kernel of the port)")
    return dict(counts=counts, acc=acc, acc_diff=acc_diff, acc_mat=acc_mat,
                step_ms=wall / c["steps"] * 1e3, busy=busy)


def phase_jlt(dev) -> dict:
    """App. B's JLT + Woodbury solver: the JAX test's problem and gate
    (correlation with the CG solution > 0.95 at m = 4096), then the
    posterior cell's T = 1024 rows of the 10⁶-node trace at m = 1024
    (G is 4 GB): correlation, wall and peak memory."""
    import torch

    from repro_torch.core import features, jlt, modulation, walks
    from repro_torch.gp import mll
    from repro_torch.graphs import generators
    from repro_torch.solvers import cg_solve

    g = generators.grid2d(7, 7, device=dev)
    tr = walks.sample_walks(g, 2024, 30, 0.2, 6)
    mod = modulation.diffusion(l_max=6)
    f = mod(mod.init(device=dev))
    rng = np.random.default_rng(0)
    train = torch.from_numpy(rng.choice(49, 18, replace=False)).to(dev)
    y = torch.from_numpy(rng.standard_normal(18).astype(np.float32)).to(dev)
    tx = features.take_rows(tr, train)
    h = mll.make_h_operator(tx, f, 0.05, 49)
    want = cg_solve(h, y, tol=1e-7, max_iters=500).x
    k1 = jlt.jlt_features(tx, f, torch.Generator(device=dev).manual_seed(3),
                          JLT["m_small"], 49)
    got = jlt.woodbury_solve(k1, 0.05, y)
    corr = float(np.corrcoef(want.cpu().numpy(), got.cpu().numpy())[0, 1])
    expect(corr > 0.95, f"jlt on grid2d(7, 7): correlation {corr:.4f} <= 0.95")
    print(f"[jlt] grid2d(7, 7), m = {JLT['m_small']}: correlation with CG {corr:.4f}")

    reset_counts()
    graph, wcfg, f, train, y = make_problem(MAIN, dev)
    n, s2, m = MAIN["n_nodes"], MAIN["sigma_n2"], JLT["m_main"]
    seed = walks.walk_seed(torch.Generator(device=dev).manual_seed(7))
    tx = walks.sample_walks_for_nodes(graph, train, seed, wcfg.n_walkers,
                                      wcfg.p_halt, wcfg.l_max)

    def solve():
        k1 = jlt.jlt_features(tx, f, torch.Generator(device=dev).manual_seed(3), m, n)
        return jlt.woodbury_solve(k1, s2, y)

    got, wall, peak = timed_call(solve, dev)
    warm = timed_call(solve, dev)[1]
    counts = counts_now()
    gate_counts("jlt", counts, ("walk_sampler", "ell_spmv"))
    wide = PATH_SHAPES["jlt"]["ell_spmv"]
    expect(wide.get((MAIN["n_train"], wcfg.slots, m), 0) > 0,
           f"jlt: no ell_spmv launch at R = {m}: {wide}")
    want = cg_solve(mll.make_h_operator(tx, f, s2, n), y, tol=1e-6, max_iters=2000).x
    corr_main = float(np.corrcoef(want.cpu().numpy(), got.cpu().numpy())[0, 1])
    expect(bool(torch.isfinite(got).all()), "jlt at N = 10⁶: non-finite solution")
    print(f"[jlt] N = {n}, T = {MAIN['n_train']}, m = {m} (G [{n}, {m}] "
          f"{n * m * 4 / 2**30:.2f} GiB): correlation with CG {corr_main:.4f}; first "
          f"{wall * 1e3:.1f} ms, warm {warm * 1e3:.1f} ms, max_memory_allocated "
          f"{mib(peak)} MiB")
    return dict(counts=counts, corr_small=corr, corr_main=corr_main, first_s=wall,
                warm_s=warm, peak=peak)


OBS_SPANS = ("walks.sample", "posterior.mean", "posterior.pathwise",
             "posterior.pathwise_chunked", "mll.fit_chunk", "serving.ingest",
             "serving.observe_batch", "serving.wave", "serving.thompson_draw",
             "bo.draw")


def obs_workload(dev) -> None:
    """The main posterior calls, one fit chunk, one serving wave and one BO
    round (the incremental loop's first round, with its refit)."""
    import torch

    from repro_torch import serving, solvers
    from repro_torch.bo import thompson
    from repro_torch.core import modulation
    from repro_torch.gp import mll
    from repro_torch.graphs import signals

    _, calls = path_calls(MAIN, dev, dev)
    for _, fn in calls:
        fn()
    _, trace_x, mod, y, _ = fit_problem(MAIN, dev)
    mll.fit_hyperparams(trace_x, mod, y, MAIN["n_nodes"],
                        torch.Generator(device=dev).manual_seed(4),
                        steps=FIT["chunk"], chunk=FIT["chunk"],
                        strategy=solvers.MLL_DEFAULT)
    calls, st, (_, _, _, nodes) = serving_calls(SERVE, dev)
    dict(calls)["ingest"]()
    dict(calls)["observe x3"]()
    loop = serving.GPServeLoop(st["state"], batch=SERVE["batch"])
    loop.run([serving.GPRequest(nodes=nodes["engine"][:SERVE["batch"]])])
    graph, wcfg = st["state"].graph, st["state"].cfg
    truth = signals.smooth_periodic_ring(SERVE["n_nodes"], seed=1)
    rng = np.random.default_rng(3)
    thompson.thompson_sampling_incremental(
        graph, wcfg, modulation.diffusion(l_max=wcfg.l_max),
        lambda idx: truth[np.asarray(idx)] + 0.1 * rng.standard_normal(len(idx)),
        17, n_init=BO["n_init"], n_steps=1, refit_every=BO["refit_every"],
        refit_steps=BO["refit_steps"], noise_std=0.1,
        n_candidates=BO["n_candidates"])
    sync(dev)


def phase_obs(dev) -> dict:
    """The obs workload under ``obs.recording(chiprun_out/obs.jsonl)``:
    the record passes ``validate``, every expected span is there, the
    ``walks.rows_sampled`` counters equal the rows of the walk kernel's
    launches, and the ``solver.cg`` histogram counts every solve made.
    Then the same workload with obs disabled: nothing recorded, nothing
    written."""
    from repro_torch import obs, solvers
    from repro_torch.obs import report

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "obs.jsonl"
    path.unlink(missing_ok=True)
    solves = {"n": 0}
    real_solve = solvers.solve

    def counted(*a, **k):
        solves["n"] += 1
        return real_solve(*a, **k)

    reset_counts()
    solvers.solve = counted
    try:
        t0 = time.perf_counter()
        with obs.recording(str(path)):
            obs_workload(dev)
        wall_on = time.perf_counter() - t0
    finally:
        solvers.solve = real_solve
    counts = counts_now()
    gate_counts("obs", counts, ("walk_sampler", "ell_spmv", "ell_spmv_t",
                                "khat_fused", "gram_block"))
    errors = report.validate(str(path))
    expect(not errors, f"obs record invalid: {errors[:5]}")
    events = report.read_events(str(path))
    metrics = events[-1]["metrics"]
    spans = {e["name"] for e in events if e["type"] == "span"}
    missing = [s for s in OBS_SPANS if s not in spans]
    expect(not missing, f"obs record lacks spans {missing}")
    rows_counted = sum(v for k, v in metrics["counters"].items()
                       if k.startswith("walks.rows_sampled{"))
    rows_launched = sum(m * c for (m, _), c in PATH_SHAPES["obs"]["walk_sampler"].items())
    expect(rows_counted == rows_launched,
           f"walks.rows_sampled {rows_counted} != rows launched {rows_launched}")
    cg_count = metrics["histograms"]["solver.cg.iters"]["count"]
    expect(cg_count == solves["n"] > 0,
           f"solver.cg.iters count {cg_count} != {solves['n']} solves")
    print(f"[obs] {path.relative_to(ROOT)}: {len(events)} events, valid; "
          f"{len(spans)} span names ({', '.join(sorted(spans))}); "
          f"walks.rows_sampled {rows_counted:.0f} = rows of the walk kernel's "
          f"launches; solver.cg.iters count {cg_count} = {solves['n']} solves; "
          f"{wall_on:.2f} s recorded")
    print(obs.summary(metrics))

    # Disabled: the same workload records nothing and writes nothing.
    obs.REGISTRY.reset()
    size = path.stat().st_size
    files = sorted(out_dir.iterdir())
    t0 = time.perf_counter()
    obs_workload(dev)
    wall_off = time.perf_counter() - t0
    snap = obs.REGISTRY.snapshot()
    expect(not obs.enabled(), "obs enabled after the recording")
    expect(not any(snap.values()), f"disabled obs recorded {snap}")
    expect(path.stat().st_size == size, "disabled obs wrote to the record")
    expect(sorted(out_dir.iterdir()) == files, "disabled obs wrote a file")
    # What the disabled call sites cost: the workload with every obs entry
    # point replaced by a no-op, in turns with the disabled runs.
    walls = {"disabled": [wall_off], "stubbed": []}
    for mode in ("stubbed", "disabled", "stubbed"):
        with obs_stubbed(mode == "stubbed"):
            t0 = time.perf_counter()
            obs_workload(dev)
            walls[mode].append(time.perf_counter() - t0)
    off, stub = (float(np.median(walls[k])) for k in ("disabled", "stubbed"))
    print(f"[obs] disabled: the same workload in {wall_off:.2f} s (recorded "
          f"{wall_on:.2f} s); registry empty, record unchanged ({size} bytes); "
          f"disabled {off:.3f} s against {stub:.3f} s with the obs entry points "
          f"stubbed out (medians of 2, in turns: "
          + ", ".join(f"{k} " + "/".join(f"{w:.3f}" for w in v)
                      for k, v in walls.items()) + ")")
    return dict(counts=counts, events=len(events), wall_on=wall_on,
                wall_off=off, wall_stub=stub)


@contextlib.contextmanager
def obs_stubbed(on: bool):
    """Replace every obs entry point the hot paths call by a no-op (when
    ``on``): the workload as if it carried no instrumentation."""
    from repro_torch import obs
    from repro_torch.obs import registry, spans, taps

    if not on:
        yield
        return

    @contextlib.contextmanager
    def no_span(*a, **k):
        yield spans._NULL

    def noop(*a, **k):
        return None

    saved = [(m, n, getattr(m, n)) for m, names in (
        (obs, ("span", "inc", "gauge", "observe", "emit_event", "tap",
               "enabled")),
        (registry, ("enabled",)), (taps, ("tap", "tap_dict", "count")))
        for n in names]
    for m, n, _ in saved:
        setattr(m, n, no_span if n == "span" else
                (lambda: False) if n == "enabled" else noop)
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


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


def graph_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed and timed with CUDA events, so that no host time falls
    between launches (a loop of short calls is otherwise bound by the host:
    see the eager numbers beside)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up outside the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del graph
    return e0.elapsed_time(e1) / reps


def bound(bytes_moved: float, flops: float,
          flop_rate: float = F32_FLOP_PER_S) -> tuple[float, str]:
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    tf = flops / flop_rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def column_index_timed(trace, n: int, label: str):
    """The trace's column index for the fused K̂ kernel; its build time (host
    clock ending in a synchronize, median of 5 builds) and size printed."""
    import torch

    from repro_torch.kernels.ell_spmv import index as kindex

    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kindex.column_index(trace.cols, trace.loads, n)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    idx = trace.column_index(n)
    print(f"[timing] khat_fused column index of [{trace.cols.shape[0]}, "
          f"{trace.cols.shape[1]}] ({label}): build {np.median(walls):.4f} ms "
          f"(median of 5), U = {idx.n_uniq} distinct columns of "
          f"{idx.order.shape[0]} non-zero slots, N = {n}")
    return idx


def device_kernels(fn, dev, reps: int = 10) -> list[str]:
    """Names of the device activities (kernels, memsets, copies) of ``reps``
    profiled calls of ``fn``, in order of first appearance (a window of one
    short call can come back from the profiler empty)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync(dev)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    expect(bool(names), "the profiler saw no device activity")
    return list(dict.fromkeys(names))


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


def phase_timing(dev, results: dict) -> list[dict]:
    import torch

    from repro_torch.core import features, linops, modulation, walks
    from repro_torch.kernels.ell_spmv import ops as eops
    from repro_torch.kernels.ell_spmv import ref as eref
    from repro_torch.kernels.walk_sampler import ops as wops

    main = results["main"]
    graph, wcfg, f, train, y = make_problem(MAIN, dev)
    n, s, t = MAIN["n_nodes"], MAIN["n_samples"], MAIN["n_train"]
    seed = main["out"]["seed"]
    # Launches of each kernel summed over the paths' runs (main, fit,
    # serving, the two BO loops, solvers and lm), each counted from 0.
    path_counts = [main["counts"], results["fit"]["counts"],
                   results["serving"]["counts"],
                   *(results["bo"][e]["counts"] for e in ("incremental",
                                                          "refit-chunked")),
                   results["solvers"]["counts"], results["lm"]["counts"],
                   *(results[p]["counts"] for p in ("baselines", "svgp", "jlt",
                                                     "obs"))]
    counts = {k: sum(c[k] for c in path_counts) for k in path_counts[0]}
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

    # 1. Walk sampling at its three shapes; then the monolithic trace again
    # for the products below.
    rows.append(timing_walks(dev, graph, seed, counts["walk_sampler"],
                             extra=results["parity-baselines"]["walk_sampler"]))
    got = wops.walk_sample(*gargs, **wkw)
    k = wcfg.slots
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
    nnz_x = int((vals_x != 0).sum())

    # 2. Φ u at the shapes the paths launch: the prior draw over the
    # monolithic trace, one chunk of the chunked products at K = 48, and one
    # at the serving and solvers width K = 144, with R = 16 (the solvers'
    # chunked samples) and R = 1 (the refit engine's chunked BO).
    a_csr = csr(vals, cols, n)
    chunk = MAIN["chunk"]
    mod = modulation.diffusion(l_max=SOLVE["l_max"])
    f_w = mod({"log_beta": torch.tensor(math.log(SOLVE["beta"]), device=dev),
               "log_sigma_f": torch.tensor(math.log(SOLVE["sigma_f"]), device=dev)})
    wide = walks.sample_walks_for_nodes(graph, nodes[:chunk], seed, SOLVE["n_walkers"],
                                        SOLVE["p_halt"], SOLVE["l_max"])
    vals_w = features.feature_values(wide, f_w).contiguous()
    spmv = [timing_spmv(dev, "prior draw", vals, cols, w, 20),
            timing_spmv(dev, "chunk", vals[:chunk], cols[:chunk], w, 100),
            timing_spmv(dev, "chunk", vals_w, wide.cols, w, 100),
            timing_spmv(dev, "chunk", vals_w, wide.cols, w[:, 0].contiguous(), 100)]
    spmv += results["parity-baselines"]["ell_spmv"]
    del wide, vals_w
    head = spmv[0]
    row("ell_spmv", head["ms"], head["plain_ms"], (head["max_abs_err"], head["rel"]),
        (head["bound_ms"], head["bound_by"]), head["library_ms"])
    by_shape = shapes_summed("ell_spmv")
    print(f"[timing] ell_spmv launches by (M, K, R) over the paths: {json.dumps(by_shape)}")
    rows[-1].update(shapes=spmv, launches_by_shape=by_shape)

    # 3. Φ_xᵀ α into [N, 16] (the chunked path's composed cross product),
    # zeroing of the output included, as the wrapper runs it.
    ax_t = csr(vals_x, cols_x, n, transpose=True)
    kern = lambda: eops.ell_spmv_t_raw(vals_x, cols_x, alpha, n)  # noqa: E731
    got = kern()
    err, rel = rel_err(got, eref.ell_spmv_t_ref(vals_x, cols_x, alpha, n))
    expect(rel <= KERNEL_RTOL, f"ell_spmv_t at the main-path shape: rel {rel:.2e}")
    ms, eager = graph_ms(kern, 20), cuda_ms(kern, 50)
    print(f"[timing] ell_spmv_t [{t},{k}] -> [{n},{s}]: graph {ms:.4f} ms, eager "
          f"loop {eager:.4f} ms")
    row("ell_spmv_t", ms,
        cuda_ms(lambda: eref.ell_spmv_t_ref(vals_x, cols_x, alpha, n), 10), (err, rel),
        bound(t * k * 8 + t * s * 4 + n * s * 4, 2 * nnz_x * s),
        cuda_ms(lambda: torch.sparse.mm(ax_t, alpha), 20))
    by_shape = shapes_summed("ell_spmv_t")
    print(f"[timing] ell_spmv_t launches by (M, K, R) over the paths: {json.dumps(by_shape)}")
    rows[-1].update(eager_ms=eager, launches_by_shape=by_shape)

    # 4a. Fused K̂_{·x} α over all N rows (pathwise_samples' cross term),
    # through the training trace's column index, as the path calls it.  The
    # bound counts what these inputs need: the row payload's columns, the
    # values of the slots on touched columns, Φ_x once, α and y.
    idx_x = column_index_timed(tx, n, "cross form and posterior CG shape")
    kern = lambda: eops.khat_fused_raw(vals, cols, vals_x, cols_x, alpha, n, idx_x)  # noqa: E731
    got = kern()
    err, rel = rel_err(got, eref.khat_matvec_ref(vals, cols, vals_x, cols_x, alpha, n))
    expect(rel <= KERNEL_RTOL, f"khat_fused at the main-path shape: rel {rel:.2e}")
    expect(torch.equal(got, kern()), "khat_fused cross form: two calls differ")
    hit = idx_x.node_map[cols.long()] >= 0
    nnz_hit = int((hit & (vals != 0)).sum())
    ms, eager = graph_ms(kern, 20), cuda_ms(kern, 20)
    print(f"[timing] khat_fused cross form [{n},{k}] x [{t},{k}] R={s}: graph "
          f"{ms:.4f} ms, eager loop {eager:.4f} ms; {100 * float(hit.float().mean()):.2f}% "
          f"of row slots on touched columns")
    row("khat_fused", ms,
        cuda_ms(lambda: eref.khat_matvec_ref(vals, cols, vals_x, cols_x, alpha, n), 3),
        (err, rel),
        bound(n * k * 4 + nnz_hit * 4 + t * k * 8 + t * s * 4 + n * s * 4,
              2 * (nnz_hit + nnz_x) * s),
        cuda_ms(lambda: torch.sparse.mm(a_csr, torch.sparse.mm(ax_t, alpha)), 10))
    del hit

    # 4b. The same kernel at the CG shape (square K̂_xx, R = 16), f32 and bf16.
    khat_shapes = []
    for dt in (torch.float32, torch.bfloat16):
        vx = vals_x.to(dt)
        kern = lambda: eops.khat_fused_raw(vx, cols_x, vx, cols_x, alpha, n, idx_x)  # noqa: E731
        got = kern()
        err, rel = rel_err(got, eref.khat_matvec_ref(vx, cols_x, vx, cols_x, alpha, n))
        expect(rel <= KERNEL_RTOL,
               f"khat_fused at the CG shape ({dt}): rel {rel:.2e}")
        expect(torch.equal(got, kern()), f"khat_fused CG shape ({dt}): two calls differ")
        ms, eager = graph_ms(kern, 200), cuda_ms(kern, 100)
        pms = cuda_ms(lambda: eref.khat_matvec_ref(vx, cols_x, vx, cols_x, alpha, n), 20)
        # Square K̂_xx: rows and cols are one payload, read once.
        b = bound(t * k * (vx.element_size() + 4) + 2 * t * s * 4,
                  4 * nnz_x * s)
        print(f"[timing] khat_fused at the CG shape (T={t}, R={s}, {dt}): kernel "
              f"{ms:.4f} ms (graph; eager loop {eager:.4f} ms), plain {pms:.4f} ms, "
              f"bound {b[0] * 1e3:.3f} us ({b[1]}), max_abs_err {err:.3e} "
              f"(rel {rel:.2e})")
        khat_shapes.append(dict(shape=[t, k, t, k, s], dtype=str(dt), ms=ms,
                                eager_ms=eager, plain_ms=pms, bound_ms=b[0],
                                bound_by=b[1], max_abs_err=err))
    # One CG iteration's operator product H p = K̂_xx p + σ²p: its device
    # work must hold nothing N-long (no fill or memset).
    h = linops.shifted(tx, f, MAIN["sigma_n2"], n)
    names = device_kernels(lambda: h.matvec(alpha), dev)
    fills = [x for x in names if "fill" in x.lower() or "memset" in x.lower()]
    expect(not fills, f"one CG iteration's H p fills memory: {fills}")
    print(f"[timing] one CG iteration's H p at T={t}, R={s}: device kernels "
          + "; ".join(names) + " (no fill, no memset)")
    # The library yardstick at the CG shape: the composed torch.sparse.mm
    # pair Φ_x(Φ_xᵀ α), timed as in 4a.
    ax = csr(vals_x, cols_x, n)
    lib = cuda_ms(lambda: torch.sparse.mm(ax, torch.sparse.mm(ax_t, alpha)), 20)
    print(f"[timing] khat_fused at the CG shape (T={t}, R={s}): library "
          f"(composed torch.sparse.mm pair) {lib:.4f} ms")
    for x in khat_shapes:
        x["library_ms"] = lib
    del w, vals, cols, a_csr, trace
    torch.cuda.empty_cache()
    timing_fit(dev, results["fit"], n)
    rows.append(timing_gram(dev, results["serving"], results["solvers"],
                            counts["gram_block"]))
    wood, solvers_cg = timing_woodbury(dev, results["solvers"],
                                       counts["woodbury_apply"])
    rows.append(wood)
    khat_row = next(x for x in rows if x["name"] == "khat_fused")
    khat_row["shapes"] = khat_shapes + [solvers_cg,
                                        results["baselines"]["khat_shape"]]
    rows.append(timing_flash(dev, counts["flash_attention"]))
    rows.append(timing_rmsnorm(dev, counts["rmsnorm"]))
    return rows


def timing_spmv(dev, label: str, vals, cols, u, reps: int) -> dict:
    """ell_spmv at one shape: within 1e-5 of scale of the plain version and
    bit-equal over two calls; device ms as graph replays and an eager loop,
    the plain version's and torch.sparse.mm's ms; the bound counts the
    payload, the rows of u that the non-zero slots touch (counted from
    these inputs) and y."""
    import torch

    from repro_torch.kernels.ell_spmv import ops, ref

    m, k = vals.shape
    n, s = u.shape[0], (1 if u.dim() == 1 else u.shape[1])
    kern = lambda: ops.ell_spmv_raw(vals, cols, u)   # noqa: E731
    got = kern()
    err, rel = rel_err(got, ref.ell_spmv_ref(vals, cols, u))
    expect(rel <= KERNEL_RTOL, f"ell_spmv {label} [{m}, {k}]: rel {rel:.2e}")
    expect(torch.equal(got, kern()), f"ell_spmv {label} [{m}, {k}]: two calls differ")
    del got
    live = vals != 0
    nnz = int(live.sum())
    seen = torch.zeros(n, dtype=torch.bool, device=dev)
    seen[cols[live].long()] = True
    touched = int(seen.sum())
    del live, seen
    ms, eager = graph_ms(kern, reps), cuda_ms(kern, reps)
    pms = cuda_ms(lambda: ref.ell_spmv_ref(vals, cols, u), 3)
    a_csr = csr(vals, cols, n)
    u2 = u.reshape(n, s)
    lib = cuda_ms(lambda: torch.sparse.mm(a_csr, u2), 10)
    del a_csr
    b = bound(m * k * 8 + touched * s * 4 + m * s * 4, 2 * nnz * s)
    instance, lanes, parts = ops.route(s, ops.aligned(u))
    print(f"[timing] ell_spmv {label} [{m}, {k}] x [{n}, {s}] ({instance}, {lanes} "
          f"lanes x {parts} parts a row): kernel {ms:.4f} ms (graph; eager loop {eager:.4f} ms), "
          f"plain {pms:.4f} ms, torch.sparse.mm {lib:.4f} ms, bound {b[0]:.4f} ms "
          f"({b[1]}; {100 * nnz / (m * k):.1f}% live slots, {touched} rows of u "
          f"touched), max_abs_err {err:.3e} (rel {rel:.2e}), bit-equal over two calls")
    torch.cuda.empty_cache()
    return dict(shape=[m, k, s], ms=ms, eager_ms=eager, plain_ms=pms,
                library_ms=lib, bound_ms=b[0], bound_by=b[1], max_abs_err=err,
                rel=rel, live=nnz / (m * k), touched=touched)


def shapes_summed(name: str) -> dict[str, int]:
    """A kernel's launches by shape, summed over the paths' runs."""
    total: dict[str, int] = {}
    for by in PATH_SHAPES.values():
        for k, n in by.get(name, {}).items():
            key = "x".join(map(str, k))
            total[key] = total.get(key, 0) + n
    return total


def walk_shape(dev, graph, seed: int, label: str, cfg: dict, m: int,
               reps: int) -> dict:
    """walk_sampler over the first ``m`` nodes of ``graph``: bit-equal to
    the plain version for every scheme, device time as graph replays (few:
    a replayed graph keeps every call's outputs) and an eager loop, the
    plain version's time, and the bound: the outputs written once and the
    adjacency row and degree of each node the walks visit (counted from
    this run's cols)."""
    import torch

    from repro_torch.kernels.walk_sampler import ops, ref, rng

    d = graph.max_deg
    nodes = torch.arange(m, dtype=torch.int32, device=dev)
    kw = dict(n_walkers=cfg["n_walkers"], p_halt=cfg["p_halt"], l_max=cfg["l_max"])
    args = (graph.neighbors, graph.weights, graph.deg, nodes, seed)
    for scheme in rng.SCHEMES:
        got = ops.walk_sample(*args, **kw, scheme=scheme)
        want = ref.walk_sample_ref(*args, **kw, scheme=scheme)
        expect(all(torch.equal(a, b) for a, b in zip(got, want)),
               f"walk_sampler {label}: {scheme} differs from the plain version")
        if scheme == "iid":
            seen = torch.zeros(graph.n_nodes, dtype=torch.bool, device=dev)
            seen[got[0].reshape(-1).long()] = True
            visited = int(seen.sum())
            del seen
        del got, want
    k = cfg["n_walkers"] * (cfg["l_max"] + 1)
    fn = lambda: ops.walk_sample(*args, **kw)   # noqa: E731
    ms, eager = graph_ms(fn, reps), cuda_ms(fn, max(reps, 5))
    pms = cuda_ms(lambda: ref.walk_sample_ref(*args, **kw), 2, warmup=1)
    b = bound(3 * m * k * 4 + m * 4 + visited * (d * 8 + 4), m * k * 6)
    print(f"[timing] walk_sampler {label} [{m}, {k}] ({cfg['n_walkers']} walkers, "
          f"l_max {cfg['l_max']}): kernel {ms:.4f} ms (graph; eager loop "
          f"{eager:.4f} ms), plain {pms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}; "
          f"{visited} nodes visited), bit-equal for {len(rng.SCHEMES)} schemes")
    torch.cuda.empty_cache()
    return dict(shape=[m, k], ms=ms, eager_ms=eager, plain_ms=pms,
                bound_ms=b[0], bound_by=b[1], visited=visited, max_abs_err=0.0)


def timing_walks(dev, graph, seed: int, launches: int, extra=()) -> dict:
    """walk_sampler at WALK_SHAPES (see :func:`walk_shape`), then the
    shapes ``extra`` that other phases measured."""
    shapes = []
    for label, cfg, m in WALK_SHAPES:
        k = cfg["n_walkers"] * (cfg["l_max"] + 1)
        reps = 40 if m < graph.n_nodes else (5 if k <= 48 else 3)
        shapes.append(walk_shape(dev, graph, seed, label, cfg, m, reps))
    shapes += list(extra)
    head = shapes[0]
    by_shape = shapes_summed("walk_sampler")
    print(f"[timing] walk_sampler launches by (M, K) over the paths: {json.dumps(by_shape)}")
    print(f"[timing] walk_sampler: kernel {head['ms']:.4f} ms, plain "
          f"{head['plain_ms']:.4f} ms, bound {head['bound_ms']:.4f} ms "
          f"({head['bound_by']}), library n/a, max_abs_err 0.000e+00 (rel 0.00e+00)")
    return dict(name="walk_sampler", route="cuda",
                source="src/repro_torch/kernels/csrc/walk_sampler.cu",
                replaces=REPLACES["walk_sampler"], launches=launches,
                max_abs_err=0.0, ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=None, shapes=shapes, launches_by_shape=by_shape)


def timing_fit(dev, fit: dict, n: int) -> None:
    """The K̂ backward at the fit's shape, and the fused kernel at the fit's
    CG width."""
    import torch

    from repro_torch.core import features
    from repro_torch.gp import mll
    from repro_torch.kernels.ell_spmv import ops as eops
    from repro_torch.kernels.ell_spmv import ref as eref

    tx, mod, probes = fit["trace_x"], fit["mod"], fit["probes"]
    f = mod(mll.init_hyperparams(mod, device=dev)["mod"])
    vals = features.feature_values(tx, f).contiguous()
    cols = tx.cols.contiguous()
    r = probes.shape[1]
    g = torch.randn(probes.shape, generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev)

    def bwd(fn):
        a = vals.clone().requires_grad_()
        y_ = fn(a)
        return lambda: torch.autograd.grad(y_, a, g, retain_graph=True)[0]

    kern = bwd(lambda a: eops.khat_fused(a, cols, a, cols, probes, n))
    plain = bwd(lambda a: eref.khat_matvec_ref(a, cols, a, cols, probes, n))
    err, rel = rel_err(kern(), plain())
    expect(rel <= KERNEL_RTOL, f"K̂ backward at the fit shape: rel {rel:.2e}")
    t_x, k = vals.shape
    nnz = int((vals != 0).sum())
    # Two scatters Φᵀ into [N, R] (each: payload + R-wide input + N·R output)
    # and two value-cotangent gathers.
    b = bound(2 * (t_x * k * 8 + t_x * r * 4 + n * r * 4) + t_x * k * 4,
              4 * nnz * r)
    kern_ms = cuda_ms(kern, 50)
    print(f"[timing] K̂ backward at the fit shape (T={t_x}, K={k}, R={r}, "
          f"2 x ell_spmv_t + plain value gathers): {kern_ms:.4f} ms, "
          f"plain {cuda_ms(plain, 10):.4f} ms, bound {b[0]:.4f} ms ({b[1]}), "
          f"max_abs_err {err:.3e} (rel {rel:.2e})")
    profile_busy("K̂ backward at the fit shape", kern, dev, kern_ms / 1e3)
    # The fit's CG solves at R = 1 + probes, through the trace's index.
    v9 = torch.cat([torch.ones_like(probes[:, :1]), probes], dim=1).contiguous()
    idx = tx.column_index(n)
    k9 = lambda: eops.khat_fused_raw(vals, cols, vals, cols, v9, n, idx)  # noqa: E731
    print(f"[timing] khat_fused at the fit's CG shape (T={t_x}, R={r + 1}): "
          f"{graph_ms(k9, 200):.4f} ms (graph; eager loop {cuda_ms(k9, 100):.4f} "
          f"ms); warm fit step {fit['warm_step_s'] * 1e3:.3f} ms "
          f"({fit['cg_iters']} CG iterations)")


def matching_pairs(vals_r, cols_r, vals_c, cols_c, n: int) -> int:
    """Pairs of non-zero slots, one of each payload, on the same column:
    Σ_col nnz_r(col)·nnz_c(col), the multiply-adds G = Φ_r Φ_cᵀ needs."""
    import torch

    def per_col(vals, cols):
        return torch.bincount(cols[vals != 0].long(), minlength=n)

    return int((per_col(vals_r, cols_r) * per_col(vals_c, cols_c)).sum())


def timing_gram(dev, serving_out: dict, solv: dict, launches: int) -> dict:
    """gram_block at each main-path shape with the serving phase's payloads
    and, for the Nyström pivot column, the solvers phase's training block
    against its first pivot; two calls bit-equal at each."""
    import torch

    from repro_torch.core import features
    from repro_torch.kernels.gram_block import ops, ref
    from repro_torch.serving import state as sstate

    st = serving_out["state"]
    vals_c = st.vals().contiguous()
    cols_c = st.trace.cols.contiguous()
    n = st.n_nodes
    rng = np.random.default_rng(8)
    block_v = features.feature_values(solv["trace_x"], solv["f"]).contiguous()
    block_c = solv["trace_x"].cols.contiguous()
    pivot = solv["precond"].pivots[:1].long()
    rows_of = {SERVE["capacity"]: (vals_c, cols_c), block_v.shape[0]: (block_v, block_c),
               -1: (block_v.index_select(0, pivot).contiguous(),
                    block_c.index_select(0, pivot).contiguous())}
    for m in sorted({sh[0] for sh in GRAM_SHAPES} - set(rows_of)):
        tq = sstate.query_rows(st, torch.from_numpy(
            rng.choice(n, m, replace=False).astype(np.int32)).to(dev))
        rows_of[m] = (features.feature_values(tq, st.f).contiguous(),
                      tq.cols.contiguous())
    shapes = []
    for (m_r, k_r, m_c, k_c) in GRAM_SHAPES:
        vr, cr = rows_of[m_r]
        vc, cc = rows_of[-1 if m_r == block_v.shape[0] else m_c]
        kern = lambda: ops.gram_block_raw(vr, cr, vc, cc)   # noqa: E731
        got = kern()
        errs = rel_err(got, ref.gram_block_ref(vr, cr, vc, cc))
        expect(errs[1] <= KERNEL_RTOL,
               f"gram_block at [{m_r},{k_r}]x[{m_c},{k_c}]: rel {errs[1]:.2e}")
        expect(torch.equal(got, kern()),
               f"gram_block at [{m_r},{k_r}]x[{m_c},{k_c}]: two calls differ")
        ms, eager = graph_ms(kern, 100), cuda_ms(kern, 100)
        pms = cuda_ms(lambda: ref.gram_block_ref(vr, cr, vc, cc),
                      20 if m_r * m_c <= 64 * 128 else 2, warmup=1)
        a_r, a_ct = csr(vr, cr, n), csr(vc, cc, n, transpose=True)
        lib = cuda_ms(lambda: torch.sparse.mm(a_r, a_ct), 10)
        nnz_r, nnz_c = int((vr != 0).sum()), int((vc != 0).sum())
        pairs = matching_pairs(vr, cr, vc, cc, n)
        # Each input read once, G written once; a multiply and an add
        # (2 float32 operations) per pair of non-zero slots whose columns
        # match: what G = Φ_r Φ_cᵀ needs on these inputs.
        b = bound((m_r * k_r + m_c * k_c) * 8 + m_r * m_c * 4, 2 * pairs)
        # The design's probes: one per (hashed row, distinct entry of a
        # probe row), the hashed side being the one with fewer rows.
        distinct = [float(ref.aggregate_rows_ref(v_, c_)[2].float().mean())
                    for v_, c_ in ((vr, cr), (vc, cc))]
        probes = m_r * m_c * (distinct[0] if m_c <= m_r else distinct[1])
        print(f"[timing] gram_block [{m_r},{k_r}]x[{m_c},{k_c}] (nnz {nnz_r} x "
              f"{nnz_c}, distinct per row {distinct[0]:.1f} x {distinct[1]:.1f}, "
              f"matching pairs {pairs}, probes {probes:.0f}): kernel {ms:.4f} ms "
              f"(graph; eager loop {eager:.4f} ms), plain {pms:.4f} ms, bound "
              f"{b[0]:.6f} ms ({b[1]}), library (torch.sparse.mm CSR x CSR, "
              f"eager loop) {lib:.4f} ms, max_abs_err {errs[0]:.3e} "
              f"(rel {errs[1]:.2e})")
        shapes.append(dict(shape=[m_r, k_r, m_c, k_c], ms=ms, eager_ms=eager,
                           plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                           library_ms=lib, max_abs_err=errs[0],
                           matching_pairs=pairs, distinct_per_row=distinct))
    head = next(x for x in shapes if x["shape"] == [512, 144, 512, 144])
    return dict(name="gram_block", route="cuda",
                source="src/repro_torch/kernels/csrc/gram_block.cu",
                replaces=REPLACES["gram_block"], launches=launches,
                max_abs_err=max(x["max_abs_err"] for x in shapes),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"], shapes=shapes)


def timing_woodbury(dev, solv: dict, launches: int) -> tuple[dict, dict]:
    """woodbury_apply at T = 4000 for r in WOOD_RANKS and R in WOOD_COLS, on
    the solvers phase's Nyström operands (r = 128 is the phase's; 64 and 256
    are built on the same H), and the fused K̂ kernel at the solvers phase's CG
    shape beside it."""
    import torch

    from repro_torch import solvers
    from repro_torch.core import features
    from repro_torch.kernels.ell_spmv import ops as eops
    from repro_torch.kernels.ell_spmv import ref as eref
    from repro_torch.kernels.woodbury_apply import ops, ref

    h = solv["h"]
    t = h.shape[0]
    gen = torch.Generator(device=dev).manual_seed(6)
    shapes = []
    for r in WOOD_RANKS:
        pc = solv["precond"] if r == SOLVE["rank"] else solvers.nystrom_precond(h, rank=r)
        b, dinv, einv = pc._b, pc._dinv, pc._einv
        for cols in WOOD_COLS:
            v = torch.randn((t,) if cols == 1 else (t, cols), generator=gen, device=dev)
            want = ref.woodbury_apply_ref(b, dinv, einv, v)
            fn = lambda: ops.woodbury_apply_raw(b, dinv, einv, v)   # noqa: E731
            x = fn()
            errs = rel_err(x, want)
            expect(errs[1] <= KERNEL_RTOL, f"woodbury_apply at T={t}, r={r}, "
                   f"R={cols}: rel {errs[1]:.2e}")
            expect(torch.equal(x, fn()), f"woodbury_apply at T={t}, r={r}, "
                   f"R={cols}: two calls differ")
            ms, eager = graph_ms(fn, 200), cuda_ms(fn, 200)
            pms = cuda_ms(lambda: ref.woodbury_apply_ref(b, dinv, einv, v), 200)
            # B, D⁻¹, E⁻¹ and v read once, out written once; a multiply-add
            # per entry of BᵀW and of B s, and of E⁻¹u.
            bd = bound((t * r + t + r * r + 2 * t * cols) * 4,
                       4 * t * r * cols + 2 * r * r * cols)
            print(f"[timing] woodbury_apply T={t} r={r} R={cols}: kernel "
                  f"{ms * 1e3:.2f} us graph, {eager * 1e3:.2f} us eager loop; plain "
                  f"{pms:.4f} ms, bound {bd[0] * 1e3:.3f} us ({bd[1]}), library "
                  f"none, max_abs_err {errs[0]:.3e}, bit-equal over two calls")
            shapes.append(dict(shape=[t, r, cols], ms=ms, eager_ms=eager,
                               plain_ms=pms, bound_ms=bd[0], bound_by=bd[1],
                               max_abs_err=errs[0]))
    # The fused K̂ kernel at the solvers phase's CG shape (K = 144, R = 1),
    # through the training trace's column index, and that CG iteration's
    # operator product, whose device work must hold nothing N-long.
    tx, f = solv["trace_x"], solv["f"]
    vals = features.feature_values(tx, f).contiguous()
    cols_x = tx.cols.contiguous()
    n = SOLVE["n_nodes"]
    idx = column_index_timed(tx, n, "solvers CG shape")
    p = torch.randn((t,), generator=gen, device=dev)
    kern = lambda: eops.khat_fused_raw(vals, cols_x, vals, cols_x, p, n, idx)  # noqa: E731
    got = kern()
    err, rel = rel_err(got, eref.khat_matvec_ref(vals, cols_x, vals, cols_x, p, n))
    expect(rel <= KERNEL_RTOL, f"khat_fused at the solvers CG shape: rel {rel:.2e}")
    expect(torch.equal(got, kern()), "khat_fused solvers CG shape: two calls differ")
    nnz = int((vals != 0).sum())
    kb = bound(t * vals.shape[1] * 8 + 2 * t * 4, 4 * nnz)
    # The library yardstick: the composed torch.sparse.mm pair Φ_x(Φ_xᵀ p) on
    # CSR copies, as at the posterior's shapes.
    ax, ax_t = csr(vals, cols_x, n), csr(vals, cols_x, n, transpose=True)
    p2 = p[:, None]
    lib = cuda_ms(lambda: torch.sparse.mm(ax, torch.sparse.mm(ax_t, p2)), 50)
    ms, eager = graph_ms(kern, 200), cuda_ms(kern, 200)
    pms = cuda_ms(lambda: eref.khat_matvec_ref(vals, cols_x, vals, cols_x, p, n), 50)
    print(f"[timing] khat_fused at the solvers CG shape ([{t}, {vals.shape[1]}], "
          f"R=1, N={n}): kernel {ms:.4f} ms (graph; eager loop {eager:.4f} ms), "
          f"plain {pms:.4f} ms, bound {kb[0] * 1e3:.3f} us ({kb[1]}), library "
          f"(composed torch.sparse.mm pair) {lib:.4f} ms, max_abs_err {err:.3e} "
          f"(rel {rel:.2e})")
    names = device_kernels(lambda: solv["h"].matvec(p), dev)
    fills = [x for x in names if "fill" in x.lower() or "memset" in x.lower()]
    expect(not fills, f"one solvers CG iteration's H p fills memory: {fills}")
    print(f"[timing] one CG iteration's H p at the solvers CG shape: device "
          "kernels " + "; ".join(names) + " (no fill, no memset)")
    solvers_cg = dict(shape=[t, vals.shape[1], t, vals.shape[1], 1],
                      dtype="torch.float32", ms=ms, eager_ms=eager, plain_ms=pms,
                      bound_ms=kb[0], bound_by=kb[1], library_ms=lib,
                      max_abs_err=err)
    head = next(x for x in shapes if x["shape"] == [t, SOLVE["rank"], 1])
    by_shape = shapes_summed("woodbury_apply")
    print(f"[timing] woodbury_apply launches by (T, r, R) over the paths: "
          f"{json.dumps(by_shape)}")
    return dict(name="woodbury_apply", route="cuda",
                source="src/repro_torch/kernels/csrc/woodbury_apply.cu",
                replaces=REPLACES["woodbury_apply"], launches=launches,
                max_abs_err=max(x["max_abs_err"] for x in shapes),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=None, shapes=shapes,
                launches_by_shape=by_shape), solvers_cg


def window_pairs(s: int, w: int) -> int:
    """(query, key) pairs that causal attention with window w leaves open
    over s positions: Σ_i min(i + 1, w)."""
    if s <= w:
        return s * (s + 1) // 2
    return w * (w + 1) // 2 + (s - w) * w


def timing_flash(dev, launches: int) -> dict:
    """flash_attention at the LM path's prefill shapes (danube, bf16,
    causal, window 4096): each instance apart (device time of graph
    replays), the wrapper's eager loop, mha_ref, SDPA with a boolean mask
    and, where the window is wider than the prompt (the same function), SDPA
    with is_causal."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    _, h, hkv, _, _, d = ATTN_CASES[-4][0]
    w = ATTN_CASES[-4][1]["window"]
    shapes = []
    for i, s in enumerate(sorted({n for _, n in LM["waves"]})):
        q, k, v = attn_inputs(dev, (1, h, hkv, s, s, d), torch.bfloat16, 300 + i)
        kw = dict(causal=True, window=w)
        want = ref.mha_ref(q, k, v, **kw)
        errs = bf16_err(ops.flash_attention(q, k, v, **kw), want)
        expect(errs[1] <= BF16_ULPS, f"flash_attention at S={s}: {errs[1]:.2f} ulps")
        cc_err = bf16_err(ops.launch(ops.CUDA_CORE, q, k, v, softcap=None, **kw),
                          want)
        expect(cc_err[1] <= BF16_ULPS,
               f"flash_attention CUDA-core at S={s}: {cc_err[1]:.2f} ulps")
        del want
        reps = 50 if s <= 1024 else 20
        ms = graph_ms(lambda: ops.launch(ops.TENSOR_CORE, q, k, v, softcap=None,
                                         **kw), reps)
        cc_ms = graph_ms(lambda: ops.launch(ops.CUDA_CORE, q, k, v, softcap=None,
                                            **kw), 5)
        eager_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, **kw), reps)
        pms = cuda_ms(lambda: ref.mha_ref(q, k, v, **kw), 2, warmup=1)
        pos = torch.arange(s, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - w)
        lib = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), reps)
        lib_causal = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps) if s <= w else None
        pairs = window_pairs(s, w)
        # q, k, v read once and o written once (bf16); a multiply-add for
        # q·k and one for p·v per head dim per open pair and query head.
        nbytes = (2 * h * s * d + 2 * hkv * s * d) * 2
        flops = 4 * d * h * pairs
        b_tc = bound(nbytes, flops, BF16_TC_FLOP_PER_S)
        b_f32 = bound(nbytes, flops)
        causal_txt = ("n/a (the window is narrower than the prompt)"
                      if lib_causal is None else f"{lib_causal:.4f} ms")
        print(f"[timing] flash_attention [1,{h},{s},{d}] / [1,{hkv},{s},{d}] bf16, "
              f"causal, window {w} ({pairs} open pairs per head, "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB): tensor-core "
              f"instance {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
              f"{100 * b_tc[0] / ms:.1f}% of the bound), CUDA-core instance "
              f"{cc_ms:.4f} ms (graph replays); wrapper eager loop "
              f"{eager_ms:.4f} ms; plain {pms:.4f} ms; library (SDPA, boolean "
              f"mask, enable_gqa) {lib:.4f} ms, SDPA is_causal {causal_txt}; "
              f"bound {b_tc[0]:.4f} ms ({b_tc[1]}, bf16 tensor cores) / "
              f"{b_f32[0]:.4f} ms ({b_f32[1]}, f32 CUDA cores); max_abs_err "
              f"{errs[0]:.3e} ({errs[1]:.2f} bf16 ulps of scale; CUDA-core "
              f"{cc_err[1]:.2f})")
        shapes.append(dict(shape=[1, h, hkv, s, d], ms=ms, cuda_core_ms=cc_ms,
                           eager_ms=eager_ms, plain_ms=pms, library_ms=lib,
                           library_causal_ms=lib_causal, bound_ms=b_tc[0],
                           bound_by=b_tc[1], bound_f32_ms=b_f32[0],
                           max_abs_err=errs[0]))
        del q, k, v, mask
        torch.cuda.empty_cache()
    head = shapes[-1]   # the 4608-token prefill, past the window
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces=REPLACES["flash_attention"], launches=launches,
                max_abs_err=max(x["max_abs_err"] for x in shapes),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"], shapes=shapes)


def host_us(fn, calls: int = 1000) -> float:
    """Host wall µs per call over ``calls`` unsynchronised calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / calls * 1e6


def timing_rmsnorm(dev, launches: int) -> dict:
    """rmsnorm at the LM path's rows (bf16 x, f32 scale), against
    rmsnorm_ref and torch.nn.functional.rms_norm with weight 1 + scale:
    device time of graph replays, the eager loop, and host time per call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops, ref

    gen = torch.Generator(device=dev).manual_seed(31)
    shapes = []
    for m, d in NORM_SHAPES:
        x = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
        s = 0.1 * torch.randn((d,), generator=gen, device=dev)
        errs = bf16_err(ops.apply(x, s), ref.rmsnorm_ref(x, s))
        expect(errs[1] <= BF16_ULPS, f"rmsnorm at [{m},{d}]: {errs[1]:.2f} ulps")
        weight = (1.0 + s).to(x.dtype)
        kern = lambda: ops.apply(x, s)  # noqa: E731
        lib_fn = lambda: F.rms_norm(x, (d,), weight=weight, eps=1e-6)  # noqa: E731
        ms = graph_ms(kern, 200)
        lib = graph_ms(lib_fn, 200)
        eager_ms = cuda_ms(kern, 200)
        lib_eager = cuda_ms(lib_fn, 200)
        pms = cuda_ms(lambda: ref.rmsnorm_ref(x, s), 100)
        host, lib_host = host_us(kern), host_us(lib_fn)
        # x read once, y written once (bf16), the scale read once (f32).
        b = bound(2 * m * d * 2 + d * 4, 4 * m * d)
        print(f"[timing] rmsnorm [{m},{d}] bf16: kernel {ms * 1e3:.2f} us, library "
              f"(F.rms_norm, weight 1 + scale) {lib * 1e3:.2f} us (graph replays); "
              f"eager loop kernel {eager_ms * 1e3:.2f} us, library "
              f"{lib_eager * 1e3:.2f} us; plain {pms:.4f} ms; bound "
              f"{b[0] * 1e3:.3f} us ({b[1]}); max_abs_err {errs[0]:.3e} "
              f"({errs[1]:.2f} bf16 ulps of scale)")
        print(f"[timing] rmsnorm [{m},{d}] host wall per call over 1000 "
              f"unsynchronised calls: wrapper {host:.1f} us, F.rms_norm "
              f"{lib_host:.1f} us ({host / lib_host:.2f}x)")
        shapes.append(dict(shape=[m, d], ms=ms, eager_ms=eager_ms, plain_ms=pms,
                           library_ms=lib, library_eager_ms=lib_eager,
                           host_us=host, library_host_us=lib_host,
                           bound_ms=b[0], bound_by=b[1], max_abs_err=errs[0]))
    head = shapes[0]    # the 4608-token prefill's rows
    return dict(name="rmsnorm", route="cuda",
                source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                replaces=REPLACES["rmsnorm"], launches=launches,
                max_abs_err=max(x["max_abs_err"] for x in shapes),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"], shapes=shapes)


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
        ("parity-gram", lambda: check_gram_cases(dev)),
        ("parity-woodbury", lambda: check_woodbury_cases(dev)),
        ("parity-lm-kernels", lambda: check_lm_kernels(dev)),
        ("main", lambda: phase_main(dev)),
        ("e2e", lambda: phase_e2e(dev)),
        ("fit", lambda: phase_fit(dev)),
        ("serving", lambda: phase_serving(dev)),
        ("bo", lambda: phase_bo(dev)),
        ("solvers", lambda: phase_solvers(dev)),
        ("lm", lambda: phase_lm(dev)),
        ("parity-baselines", lambda: check_baseline_kernels(dev)),
        ("baselines", lambda: phase_baselines(dev)),
        ("svgp", lambda: phase_svgp(dev)),
        ("jlt", lambda: phase_jlt(dev)),
        ("obs", lambda: phase_obs(dev)),
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
        kernels = phase_timing(dev, results)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: phase timing FAILED", file=sys.stderr)
        return 1
    expect(len(kernels) == len(REPLACES), "timing rows missing")
    print(f"[phase] all phases ok in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
