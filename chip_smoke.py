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
               over two calls; gram_aggregate on one payload bit-equal to its
               plain version at the main path's [1024, 48], the solvers'
               [4000, 144] and the track's [149832, 900]; ell_spmv's instances at R in {1-D, 1, 2, 3,
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
               path's rows, every config width (MLA's 512 and 1536, Mamba's
               5120 and 7168 among them), the train step's [4096, 2560],
               M = 0, D = 2566 and an unaligned base; flash_attention at the
               JAX tests' nine cases and the LM shapes (danube at S = 1024
               and 4608, window 4096, and the train step's 2 x 2048;
               gemma2-27b's D = 144 with softcap 50; gemma3-4b's D = 320,
               gemma3-12b's 240, zamba2's 112; cross shapes Sq = 128 and
               448 over Skv = 1500 and 1024 over 1600; B·H = 2049·32, past
               a grid dimension's 65535), f32 and bf16, and strided
               and misaligned bf16 views, each gated on the instance the
               routing rule names (bf16 with D ≤ 256, D % 8 = 0, aligned:
               the tensor cores); and the gradients of a next-token
               cross-entropy of model.forward (danube at 2 layers, d_model
               256, f32) on the card against the CPU, every parameter
               within 1e-3 of its gradient's scale (the two kernels'
               autograd Functions: kernel forward, plain backward; under
               danube's remat "dots" the backward re-launches both).
  3. main      ring(10⁶, k=3), 8 walkers, p_halt 0.2, l_max 5 (K = 48),
               T = 1024 observations, 16 samples: posterior_mean,
               pathwise_samples on the monolithic trace and
               pathwise_samples_chunked (chunk 65536).  Launch counts are set
               to 0 just before and read just after; every kernel must have
               launched (walk_sampler_vals: the chunks' walks), CG must
               converge, chunked must equal monolithic; walk_sample_vals
               bit-equal to its plain version and to walk_sample then
               (loads·valid)·f[lens] at the first and the padded last
               chunk, every scheme.
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
 10. train     h2o-danube-1.8b at its published width and depth (24 layers,
               1.75 B params, bf16 activations, remat "dots", float32 params,
               mu and nu updated in place): AdamW(1e-3, wd 0.01, clip 1) on
               2 x 2048 tokens of TokenStream(seed 0), 2 warm-up and 8 timed
               steps on one batch, then 3 from the stream.  Gates: finite
               losses, the overfit loss falls, every step launches
               flash_attention 48 times (24 forward, 24 recomputed under
               remat), all on the tensor cores, and rmsnorm 97 times.  Step
               ms, tokens/s, peak memory, busy share, the top ops and the
               GEMM work's share of the bf16 peak.  Then at 2 layers: remat
               none/dots/full bit-equal (loss and every gradient), launches
               re-counted; microbatches 2 vs 1 in float32 (mu, nu 1e-5,
               params 1e-5 where Adam's step is determined); one step card
               vs CPU in float32, window 512 (1e-4); train_loop stopped
               after its step-3 checkpoint and resumed to 6 against 6
               straight steps (1e-6).
 11. lm-archs  the nine other configs at their published widths, each
               stage's repeat cut to 1 (whisper-base whole): prefill 4 x
               1024 tokens (whisper 448, with 1500 encoder frames; llama-
               vision with 1600 patch embeddings) and 8 decode steps, bf16,
               flash and rmsnorm launches gated per call against the count
               of attention-kind and encoder layers and norms; decode vs
               forward in float32 (1e-3; deepseek naive and absorbed); one
               train step at 1 x 512 tokens for all but deepseek-v2-236b
               (its one-layer train state is ≈72 GB).
 12. parity-baselines
               the shapes the baselines give the kernels: ell_spmv at R = 1024
               over [1024, 48] rows of the 10⁶-node trace (u 4 GiB) and at
               R = 4096 over [1024, 48] rows of a 65536-node ring (u 1 GiB),
               past 32 float4 lanes (column chunks), within 1e-5 of scale and
               bit-equal over two calls; walk_sampler at the SVGP trace
               (SBM 2500, 500 walkers, l_max 5, K = 3000) and the baselines'
               (grid 64x64, 100 walkers, l_max 10, K = 1100), bit-equal to
               the plain version for every scheme; each timed for the result
               line.
 13. baselines the paper's comparison where O(N³) runs: grid2d(64, 64),
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
 14. svgp      bench_classification.py's full mode: SBM(2500, 7), 80/20
               split, K = 3000, 150 inducing nodes, 600 steps: accuracy
               (gate: twice chance), ms a step and its busy share, beside the
               exact diffusion and Matérn classifiers; walk_sampler launched.
 15. jlt       the JLT + Woodbury solver: the JAX test's problem (grid2d(7, 7),
               m = 4096; gate: correlation with CG > 0.95), then the
               posterior cell's T = 1024 rows at N = 10⁶, m = 1024 (G 4 GiB):
               correlation, wall, peak; ell_spmv launched at R = 1024.
 16. obs       the main posterior calls, one fit chunk, one serving wave and
               one BO round under obs.recording(chiprun_out/obs.jsonl): the
               record validates, every expected span is there,
               walks.rows_sampled equals the rows of the walk kernel's
               launches, and the solver.cg histogram counts every solve; the
               summary table; then the same calls with obs disabled record
               and write nothing.
 17. resilience
               at the serving width (ring(10⁶), K = 144, capacity 128): a
               ResilientServer (journal, a checkpoint every 2 ops,
               forget_oldest) under nan_payload 0.01, inf_payload 0.005,
               chol_fail 0.05, cg_stall 1 takes five observe batches of 32
               (the last past capacity), a forget and a refit(f·1.02), then
               refit_alpha(escalate=True) and GPServeLoop(batch 64) over 512
               nodes; gates: rejected = the appends _hash01 poisons (counted
               on the host), a finite Cholesky, every query answered
               finitely, the ladder resolved in one extra rung.  The same
               ops in a child process under kill_at:5 exit 113 with 5
               journalled ops; recover() from checkpoint + tail within 1e-5
               of scale of an uninterrupted run on 256 nodes.  The escalated
               Nyström solve on the solvers phase's block under cg_stall:1
               (2 attempts, 1 resolved, within 1e-4 of "none") and cg_stall:9
               (exhausted, the best iterate).  CheckpointManager on the
               serving state (blocking, async, restore bit-equal) and a BO
               run stopped after 3 rounds and resumed to 6 from its
               checkpoint (finite regret).  Prints journal µs per op, save
               and restore ms, recovery ms and ms per replayed event, query
               p50/p99 with the plan and without, and each rung's ms.
 18. fleet     bench_serving_load.py's full mode at the serving width
               (ring(10⁶), K = 144, capacity 128): its seeded stream (64
               warm observations, 96 ticks of 8 appends, forgets down to 96
               live, Poisson(4) requests of 16 nodes; batch 64, max_pending
               512) through GPServeLoop and GPFleetLoop in turns from
               identically rebuilt states: requests/s, p50/p99 latency and
               each loop's busy share over ticks 4-5; gate: every
               request answered, the fleet's means and variances within
               1e-5 of scale of the sync loop's.  Under a one-rank NCCL
               process group: ShardedServeState over the replay's state
               (moments on 256 nodes, a 3-sample Thompson draw on 8, after
               observe_batch / forget / forget_batch and a chol_fail:1
               append with its refit, and a fleet over it against the sync
               engine), bit for bit; sharded_cg_solve and
               sharded_cg_solve_chunked (chunk 65536) on the main-path trace
               within 1e-4 of scale of the single-device solve, and
               sharded_posterior_sample over its 1024 rows, finite, with
               ell_spmv, ell_spmv_t and walk_sampler_vals (the chunked
               solve's walks) launched and khat_fused not; then the fleet in a child process under kill_at:5
               exits 113 at 'serving.fleet.observe' with the killed observe
               journalled, and recover() equals the journalled fold bit for
               bit on 256 nodes.
 19. sharding  (a) flash_attention with q_offset at the query shards of the
               sequence-parallel cells on the 16-wide model axis (gemma3-4b's
               prefill_32k, 8 heads of 320, causal and window 1024; whisper-
               base's, 8 heads of 64 on the tensor cores), f32 and bf16,
               against mha_ref(q_offset=...), the last shard of each timed
               beside the plain version and SDPA; at q_offset 0 the outputs'
               digests equal those of the kernel before q_offset existed
               (commit 90fbc73; both instances).
               (b) danube at full width and depth with fsdp, ZeRO-1 and
               sp_attn: one train step with params, μ and ν as DTensors
               (launch.sharding's placements) on a 1×1 NCCL DeviceMesh,
               against the plain step on the same batch, loss and params
               within 1e-6 (bit-equal expected); launch counts set to 0
               before the step and gated after (48 flash, all tensor-core,
               97 rmsnorm); step ms and peak MiB.  (c) the dry run of
               danube's four cells and the GRF-GP cell, plain and compact,
               on both production meshes (fake process groups of 256 and
               512 ranks, no card): per-device FLOPs, bytes, wire bytes,
               argument / temp bytes and the H100 roofline terms, gated on
               status ok and FLOPs > 0; records in chiprun_out/dryrun/.
 20. timing    each kernel at the main-path shapes with CUDA events: kernel,
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
               adjacency rows of the nodes the walks visit, and its vals
               entry at the chunk, bit-equal to its plain version for every
               scheme, beside the composition it replaces;
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

The new shapes of phase 12 and khat_fused's at phase 13's CG shape join
their kernels' `shapes` lists in that line, and so do flash_attention and
rmsnorm at the train step's shapes ([2, 32, 2048, 80] causal, SDPA
is_causal beside; [4096, 2560]) with their launches a step, and
flash_attention's offset shards of phase sharding.

Each path (main, fit, serving, each BO loop, solvers, lm, train, each
call of lm-archs, baselines, svgp, jlt, obs, each part of resilience and
of fleet, the sharded train step) is driven with every launch
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
# The resilience phase at the serving width: serve_gp's chaos plan over a
# ResilientServer (journal, checkpoints every 2 ops, forget_oldest), five
# observe batches of 32 nodes (the last past capacity 128), forget, refit;
# kill_at 5 falls after the checkpoint of op 4 and before that of op 6.
RESIL = dict(plan="nan_payload:0.01,inf_payload:0.005,chol_fail:0.05,cg_stall:1,seed:3",
             seed=21, batches=5, batch=32, n_query=512, forget_slot=3,
             checkpoint_every=2, kill_at=5, latency_rounds=3, journal_ops=1000,
             bo_rounds=3)
# The fleet phase at bench_serving_load.py's full mode (its `_worker` and
# `_make_schedule`): ring(10⁶, k=3), 16 walkers, p_halt 0.1, l_max 8
# (K = 144), capacity 128, σ² 0.05, 64 warm observations drawn from
# default_rng(N), then 96 ticks drawn from default_rng(0), each of 8 appends,
# forgets down to 96 live, Poisson(4) requests of 16 nodes; batch 64,
# max_pending 512.  Both loops warm up on the first 8 ticks, then replay
# all 96 in turns (`order`); the busy shares come from one profiled replay
# of ticks 4-5 (the first with forgets, from a state the earlier ticks'
# mutations advanced) beside its unprofiled wall.  The sharded part serves
# 256 moment nodes, an 8-node 3-sample Thompson draw and 8 requests of 16;
# the distributed GP solves on the main-path trace (K = 48) at σ² 0.1 with
# SHARDED_DEFAULT (tol 1e-5), the chunked solve at chunk 65536, the
# posterior sample over the main path's 1024 training rows; kill_at 5 falls
# on the fleet's 4th observe.
FLEET = dict(n_nodes=1_000_000, ring_k=3, n_walkers=16, p_halt=0.1, l_max=8,
             capacity=128, sigma_n2=0.05, warm=64, ticks=96, observes_per_tick=8,
             live_hi=96, lam_queries=4.0, req=16, batch=64, max_pending=512,
             seed=0, warm_ticks=8, busy_ticks=(4, 6), order=("sync", "fleet"),
             n_moments=256, n_cand=8, n_samples=3, n_requests=8, kill_at=5)
DIST = dict(sigma_n2=0.1, chunk=65536, rtol=1e-4)
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
# The gradient check of the two LM kernels' autograd Functions: danube cut
# to 2 layers at d_model 256 (4 heads of 64, 2 KV heads), f32, 2 x 64 tokens;
# each gradient within 1e-3 of its own scale of the CPU's (the forward's
# kernel sums in another order, then the same plain backward).
LM_GRADS = dict(layers=2, d_model=256, heads=4, kv_heads=2, head_dim=64,
                d_ff=512, vocab=1000, batch=2, seq=64, seed=3, rtol=1e-3)
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
    # Slice 12: the train step's shape, the new configs' head dims (gemma3-
    # 12b's 240, zamba2's shared block's 112) and the cross-attention calls
    # of whisper-base (448 queries over 1500 frames, not a multiple of the
    # tile) and llama-3.2-vision (1024 over 1600 patches).
    ((2, 32, 8, 2048, 2048, 80), dict(window=4096)),
    ((1, 16, 8, 1024, 1024, 240), dict(window=1024)),
    ((1, 32, 32, 1024, 1024, 112), {}),
    ((4, 8, 8, 448, 1500, 64), dict(causal=False)),
    ((1, 32, 8, 1024, 1600, 128), dict(causal=False)),
]
# The LM path's rmsnorm rows: a prefill at each prompt length, a decode step.
NORM_SHAPES = [(4608, 2560), (1024, 2560), (4, 2560)]
# LM training on h2o-danube-1.8b at its published width and depth (24
# layers, bf16 activations, a float32 train state updated in place, remat
# "dots", the config's): AdamW(1e-3, weight decay 0.01, clip 1.0), 2 x 2048
# tokens from TokenStream(seed 0): 2 warm-up and 8 timed steps on its first
# batch (overfit), then 3 steps from the stream.
TRAIN = dict(arch="h2o-danube-1.8b", seed=0, batch=2, seq=2048, lr=1e-3,
             weight_decay=0.01, clip=1.0, warm=2, timed=8, stream=3)
# The train step's rmsnorm rows: 2 x 2048 tokens at d_model 2560.
TRAIN_NORM = (TRAIN["batch"] * TRAIN["seq"], 2560)
# Its checks at full width cut to 2 layers: remat none/dots/full on the
# train batch; microbatches 2 against 1 (float32); one step card against CPU
# (float32, window 512, 1 x 1024 tokens); train_loop stopped after its
# step-3 checkpoint and resumed to 6 against 6 straight steps (2 x 256
# tokens).  Tolerances, relative to each leaf's scale: the microbatch step
# 1e-5 (float32 sums of two halves against one); card vs CPU 1e-4 (two
# layers of float32 forward through the kernels, the same plain backward);
# the resume 1e-6 (the JAX test's; the embedding's backward sums with
# atomics on the card).  Adam's first step is g/(|g| + ε): an element where
# the two runs' gradient difference could move the step by more than a
# tenth of the tolerance (near g = 0) is held to Adam's bound of 2·lr
# instead, and counted (adam_step_check).
TRAIN_CHECK = dict(layers=2, window=512, cpu_batch=1, cpu_seq=1024,
                   resume_steps=6, kill_at=3, resume_batch=2, resume_seq=256,
                   micro_rtol=1e-5, cpu_rtol=1e-4, resume_rtol=1e-6)
# The nine other configs at their published widths, random weights from the
# seed, bf16; each stage's repeat cut to 1 (whisper-base, 74 M parameters,
# runs whole): 4 prompts of 1024 tokens (whisper-base 448, its decoder's
# context) and 8 greedy tokens; decode against forward in float32 (a
# 16-token prompt and 8 steps, cache f32, capacity factor 8, deepseek naive
# and absorbed) within 1e-3; a train step at 1 x 512 tokens for each config
# whose one-repeat train state fits at 16 bytes a parameter (deepseek-v2-
# 236b's one MLA + MoE layer and embedding are ≈4.65 B parameters, ≈74 GB:
# it trains only in the reduced-config gpu tests).
ARCHS = dict(names=("zamba2-7b", "llama-3.2-vision-11b", "deepseek-v2-236b",
                    "moonshot-v1-16b-a3b", "mamba2-2.7b", "whisper-base",
                    "gemma3-4b", "gemma3-12b", "gemma2-27b"),
             whole=("whisper-base",), no_train=("deepseek-v2-236b",),
             seed=0, batch=4, prompt=1024, prompts={"whisper-base": 448}, new=8,
             check_prompt=16, check_steps=8, check_rtol=1e-3,
             train_batch=1, train_seq=512)

# Slice 13, phase sharding.
# (a) flash_attention with q_offset at the local shapes of the sequence-
# parallel cells on the 16-wide model axis (the query heads do not divide
# it, so each rank takes S/16 query rows over the whole K/V and its rows'
# global offset): gemma3-4b's prefill_32k (8 heads, 4 KV, of 320; 2 prompts
# a data rank), its global layer and its local one (window 1024), and
# whisper-base's decoder (8 heads of 64, the tensor-core instance in bf16),
# at the shards listed, f32 and bf16 against mha_ref(q_offset=...).
OFFSET_CASES = [
    ((2, 8, 4, 32768, 320), {}, 16, (0, 1, 15)),
    ((2, 8, 4, 32768, 320), dict(window=1024), 16, (1, 15)),
    ((2, 8, 8, 32768, 64), {}, 16, (0, 7, 15)),
]
# ... and at q_offset = 0, bit for bit against the kernel as it was before
# the argument existed (commit 90fbc73): sha-256 prefixes of the
# outputs at these cases (inputs from numpy, seeds 500 + i; f32 then bf16),
# measured with flash_digests on that commit's build on an H100 80GB HBM3.
PRE_OFFSET_CASES = [((1, 32, 8, 1024, 1024, 80), dict(window=4096)),
                    ((1, 8, 4, 2048, 2048, 320), dict(window=1024)),
                    ((1, 4, 4, 128, 128, 32), dict(softcap=30.0)),
                    ((1, 8, 8, 128, 1500, 64), dict(causal=False))]
PRE_OFFSET_DIGESTS = ["74e84b1d94cb0516", "3731e14b934ab421", "6b3623e57149ff71",
                      "f5c3e5d31cba8e09", "15f0c2827dda18d1", "5a33363a9e70db99",
                      "b7d6b1692b573070", "89f66f1341828554"]
# (b) TRAIN's config with fsdp, ZeRO-1 and sp_attn: one step on its first
# stream batch with params, μ and ν as DTensors (sharding.param_shardings,
# opt_shardings) on a 1×1 NCCL DeviceMesh, against the plain step on the
# same batch: loss and params within 1e-6 of scale (bit-equal expected: a
# one-rank mesh runs the same local ops).
# (c) the dry run of TRAIN's arch at its four shapes and the GRF-GP cell,
# plain and compact, on both production meshes (fake process groups of 256
# and 512 ranks): status ok and FLOPs > 0.
SHARD = dict(rtol=1e-6, dry_arch="h2o-danube-1.8b")

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
    for name in ("walk_sampler", "walk_sampler_vals", "ell_spmv", "ell_spmv_t",
                 "khat_fused", "gram_aggregate"):
        expect(counts[name] > 0, f"main path never launched {name}")
    check_path_outputs(out, MAIN, "main")
    check_coalesce_main(out["seed"], dev)
    check_chunk_vals_main(out["seed"], dev)
    warm = warm_times(out["calls"], dev)
    for label, t in timings.items():
        print(f"[main] {label}: first call {t['s'] * 1e3:.1f} ms, warm median "
              f"{warm[label] * 1e3:.1f} ms (of 3), max_memory_allocated "
              f"{t['max_mem'] / 2**20:.0f} MiB, launches {json.dumps(t['launches'])}")
    print(f"[main] launches over the main path: {json.dumps(counts)}")
    device_busy(out["calls"], dev, ("posterior_mean", "pathwise_samples",
                                    "pathwise_samples_chunked"), warm)
    return dict(counts=counts, out=out, timings=timings)


def check_coalesce_main(seed, dev) -> None:
    """The coalesced training payload the main path's solves read, built on
    the card (aggregate kernel), against the plain build of the same trace
    on the CPU: payload, columns and column index bit for bit."""
    import torch

    from repro_torch.core import features, walks

    graph, wcfg, f, train, _ = make_problem(MAIN, dev)
    tx = features.take_rows(walks.sample_walks(graph, seed, wcfg.n_walkers,
                                               wcfg.p_halt, wcfg.l_max), train)
    n = graph.n_nodes
    got = features.coalesce(tx, f, n)
    cpu = torch.device("cpu")
    want = features.coalesce(walks.WalkTrace(
        cols=tx.cols.to(cpu), loads=tx.loads.to(cpu), lens=tx.lens.to(cpu)),
        f.to(cpu), n)
    pairs = [("vals", got.vals, want.vals), ("cols", got.cols, want.cols)] + [
        (f"index.{k}", getattr(got.index, k), getattr(want.index, k))
        for k in ("uniq", "order", "seg", "node_map")]
    for name, a, b in pairs:
        expect(a.shape == b.shape and torch.equal(a.cpu(), b),
               f"main: coalesced {name} on the card differs from the plain build")
    kept = int((want.vals != 0).sum())
    live = int((features.feature_values(tx, f) != 0).sum())
    print(f"[main] coalesced training payload [{tx.n_nodes}, {tx.slots}] -> "
          f"{tuple(got.vals.shape)} on the card equals the plain build bit for "
          f"bit (values, columns, index); kept {kept} of {live} live slots")


def check_chunk_vals_main(seed, dev) -> None:
    """The chunked products' (cols, vals) as the sampler writes them
    (walk_sample_vals_launch) on the card, bit for bit, against its plain
    version (walk_sample_vals_ref) and against the composition it replaces
    (walk_sample, then (loads·valid)·f[lens]), for every scheme: the main
    path's first chunk and its padded last one."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.walk_sampler import ref, rng

    graph, wcfg, f, _, _ = make_problem(MAIN, dev)
    n, chunk = graph.n_nodes, MAIN["chunk"]
    last = (n - 1) // chunk * chunk
    kw = dict(n_walkers=wcfg.n_walkers, p_halt=wcfg.p_halt, l_max=wcfg.l_max)
    gargs = (graph.neighbors, graph.weights, graph.deg)
    idx = torch.arange(chunk, device=dev)
    for start in (0, last):
        n_valid = min(n - start, chunk)
        nodes = torch.clamp(start + idx, max=n - 1).to(torch.int32)
        valid = (idx < n_valid).to(torch.float32)
        for scheme in rng.SCHEMES:
            where = f"rows {start}+{chunk} ({n_valid} valid), {scheme}"
            cols, vals = dispatch.walk_sample_vals(
                *gargs, nodes, f, n_valid, seed, **kw, scheme=scheme)
            plain_c, plain_v = ref.walk_sample_vals_ref(
                *gargs, nodes, f, n_valid, seed, **kw, scheme=scheme)
            expect(torch.equal(cols, plain_c) and torch.equal(vals, plain_v),
                   f"main: walk_sample_vals at {where}, differs from its plain "
                   f"version")
            del plain_c, plain_v
            want_c, loads, lens = dispatch.walk_sample(
                *gargs, nodes, seed, **kw, scheme=scheme)
            want_v = (loads * valid[:, None]).to(f.dtype) * f[lens]
            expect(torch.equal(cols, want_c) and torch.equal(vals, want_v),
                   f"main: walk_sample_vals at {where}, differs from the "
                   f"composed values")
    print(f"[main] walk_sample_vals [{chunk}, {wcfg.slots}] equals its plain "
          f"version and walk_sample then (loads·valid)·f[lens] bit for bit, "
          f"{len(rng.SCHEMES)} schemes, at the first chunk and the last "
          f"({n - last} valid rows)")


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
    # The aggregate launched alone on one payload (the coalesced K̂ payload's
    # build) against aggregate_rows_ref, bit for bit, padding included: the
    # main path's training block [1024, 48], the serving width, the solvers'
    # block [4000, 144], the wind example's K = 900 with each row's first
    # column repeated 100 times, in a block and at the whole track's 149832
    # rows, ragged K, an empty payload.
    before = ops.LAUNCHES["gram_aggregate"]
    agg_cases = [(1024, 48, False), (1024, 144, False), (4000, 144, True),
                 (4096, 900, True), (149832, 900, True), (300, 33, True),
                 (50, 70, False), (0, 144, False)]
    for m, k, rep in agg_cases:
        vals, cols = _gram_payload(rng, m, k, 5000, True, 0.3)
        if rep and m:
            cols[:, ::k // 100 or 1] = cols[:, :1]
        tv, tc = t(vals), t(cols)
        got = ops.aggregate_rows_raw(tv, tc)
        want = ref.aggregate_rows_ref(tv, tc)
        expect(all(torch.equal(a, b) for a, b in zip(got, want)),
               f"gram_aggregate [{m}, {k}]: not bit-equal to aggregate_rows_ref")
        expect(all(torch.equal(a, b) for a, b in
                   zip(got, ops.aggregate_rows_raw(tv, tc))),
               f"gram_aggregate [{m}, {k}]: two calls differ")
    launched = ops.LAUNCHES["gram_aggregate"] - before
    expect(launched == 2 * sum(1 for m, _, _ in agg_cases if m),
           f"gram_aggregate launched {launched} times in its parity cases")
    print(f"[parity] gram_aggregate on one payload equals aggregate_rows_ref bit "
          f"for bit (columns, counts, sums, padding) and repeats, in "
          f"{len(agg_cases)} cases up to [149832, 900]; {launched} launches")

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
        # record_function ranges (obs spans under a profiler) are mirrored
        # onto the device timeline as annotations; they are not device work.
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
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
              (2, 3840), (6, 4096), (7, 4608), (37, 2566), (0, 2560),
              (4096, 2560), (9, 512), (11, 1536), (64, 5120), (64, 7168),
              (13, 3584), (1024, 1536)]
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
          f"to 4608, every config width, MLA's q_norm 1536 and kv_norm 512, "
          f"Mamba's out_norm 5120 and 7168, D = 2566), a 3-D input and an "
          f"unaligned base: f32 rel {worst[torch.float32]:.2e} (limit "
          f"{NORM_RTOL:g}), bf16 {worst[torch.bfloat16]:.2f} ulps of scale "
          f"(limit {BF16_ULPS})")


def check_lm_grads(dev) -> None:
    """Autograd through ``model.forward`` on the card (rmsnorm and
    flash_attention as autograd Functions: the kernels forward, the plain
    versions backward) against the CPU: the mean next-token cross-entropy's
    gradient with respect to every parameter of danube at LM_GRADS' narrow
    width, f32.  Every parameter with a gradient on the CPU has one on the
    card, within LM_GRADS["rtol"] of that gradient's scale."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.models import model

    c = LM_GRADS
    base = configs.get_config(LM["arch"])
    cfg = dataclasses.replace(
        base, dtype="float32", cache_dtype="float32", d_model=c["d_model"],
        n_heads=c["heads"], n_kv_heads=c["kv_heads"], head_dim=c["head_dim"],
        d_ff=c["d_ff"], vocab_size=c["vocab"],
        stages=((c["layers"], base.stages[0][1]),))
    params = model.init_params(cfg, seed=c["seed"], device=dev)
    tok = torch.from_numpy(np.random.default_rng(c["seed"]).integers(
        0, cfg.vocab_size, (c["batch"], c["seq"])))

    def grads(p, device):
        leaves = model.tree_leaves(p)
        for x in leaves:
            x.requires_grad_(True)
        t = tok.to(device)
        logits, _ = model.forward(p, cfg, t)
        loss = torch.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, logits.shape[-1]), t[:, 1:].reshape(-1))
        return loss, torch.autograd.grad(loss, leaves, allow_unused=True)

    before = (fops.LAUNCHES["flash_attention"], rops.LAUNCHES["rmsnorm"])
    card_loss, card = grads(params, dev)
    launched = (fops.LAUNCHES["flash_attention"] - before[0],
                rops.LAUNCHES["rmsnorm"] - before[1])
    # The forward's launches, and under danube's remat "dots" the backward's
    # recompute of each layer's body (lm_launches counts both).
    expect(launched == lm_launches(cfg, "train"),
           f"lm grads: kernel launches (flash, rmsnorm) {launched}, expected "
           f"{lm_launches(cfg, 'train')}")
    host_loss, host = grads(model.tree_map(lambda a: a.detach().cpu(), params),
                            torch.device("cpu"))
    worst = rel_err(card_loss.detach().cpu(), host_loss.detach())[1]
    for i, (a, b) in enumerate(zip(card, host)):
        expect((a is None) == (b is None),
               f"lm grads: parameter {i} has a gradient on one device only")
        if b is not None:
            worst = max(worst, rel_err(a.cpu(), b)[1])
    expect(worst <= c["rtol"], f"lm grads card vs CPU: rel {worst:.2e}")
    print(f"[parity] lm gradients: danube at d_model {c['d_model']}, "
          f"{c['layers']} layers, f32, [{c['batch']}, {c['seq']}] tokens: every one "
          f"of {sum(g is not None for g in host)} parameters with a CPU gradient "
          f"has one on the card (kernels forward, plain backward), worst rel "
          f"{worst:.2e} of each gradient's scale (limit {c['rtol']:g})")


def check_lm_kernels(dev) -> None:
    check_rmsnorm_cases(dev)
    check_flash_cases(dev)
    check_lm_grads(dev)


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
# Slice 12: LM training and the other layer kinds
# --------------------------------------------------------------------------


def lm_launches(cfg, mode: str) -> tuple[int, int]:
    """The (flash_attention, rmsnorm) launches one call of ``mode`` makes:
    "prefill", "decode", "forward", or "train" (a forward, plus the
    recompute of every remat-wrapped repeat under remat dots or full: all
    but the final norm and the encoder's).  Attention layers (attn,
    cross_attn, shared_attn) and encoder layers launch attention in every
    mode but decode; their norms: one for attention and one for an MLP or
    MoE; MLA three (norm, q_norm, kv_norm) and two more in prefill (its
    cache's latents); Mamba two (norm, out_norm)."""
    flash = norms = 0
    for repeat, pattern in cfg.stages:
        for spec in pattern:
            ffn = int(spec.has_mlp and spec.kind not in ("mamba", "shared_attn"))
            if spec.kind in ("attn", "cross_attn"):
                f, n = 1, 1 + ffn
            elif spec.kind == "shared_attn":
                f, n = 1, 2
            elif spec.kind == "mla":
                f, n = 0, (5 if mode == "prefill" else 3) + ffn
            else:   # mamba
                f, n = 0, 2
            flash += repeat * f * (mode != "decode")
            norms += repeat * n
    enc = 0
    if cfg.n_enc_layers and mode != "decode":
        layers = cfg.n_enc_layers * cfg.enc_pattern_mult
        flash += layers
        norms += 2 * layers
        enc = 1
    if mode == "train" and cfg.remat in ("dots", "full"):
        flash, norms = 2 * flash, 2 * norms
    return flash, norms + 1 + enc


def launched(c0: dict) -> dict:
    """The launches since the counts ``c0``."""
    c1 = counts_now()
    return {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}


def adam_step_check(label, new, ref, grads, ref_grads, lr, rtol) -> dict:
    """Params after one Adam step against a reference's, leaf by leaf.
    ``grads`` / ``ref_grads`` are the clipped gradients each step used.
    Adam's first step is g/(|g| + ε), whose slope ε/(|g| + ε)² is largest
    near g = 0: an element's measured gradient difference d moves its step
    by at most lr·d·ε/(max(|g| − d, 0) + ε)².  Every element where that is
    within a tenth of ``rtol`` of the leaf's scale is held to ``rtol``; the
    rest, whose step the two runs' gradients do not determine, are held to
    Adam's bound 2·lr (plus the weight decay's share).  Returns each leaf's
    share of the latter, by path."""
    import torch

    eps = 1e-8
    worst, past, total, shares = 0.0, 0, 0, {}
    for (path, a), b, g, h in zip(paths_of(new), paths_of(ref), paths_of(ref_grads),
                                  paths_of(grads), strict=True):
        a, b = a.detach().cpu().double(), b[1].detach().cpu().double()
        g, h = g[1].cpu().double(), h[1].cpu().double()
        scale = max(float(b.abs().max()), 1e-30)
        gap = (g - h).abs()
        moved = lr * gap * eps / ((g.abs() - gap).clamp(min=0) + eps) ** 2
        sure = moved <= 0.1 * rtol * scale
        shares[path] = float((~sure).sum()) / max(b.numel(), 1)
        diff = (a - b).abs()
        past += int((diff > rtol * scale).sum())
        total += b.numel()
        rel = float((diff * sure).max()) / scale if b.numel() else 0.0
        expect(rel <= rtol, f"{label}: {path} after the step differs by rel {rel:.2e}")
        expect(float(diff.max()) <= 2.05 * lr, f"{label}: {path} past Adam's bound")
        worst = max(worst, rel)
        del a, b, g, h, gap, moved, diff, sure
    torch.cuda.empty_cache()
    exempt = {k: round(v, 6) for k, v in shares.items() if v}
    print(f"[train] {label}: params after one step within rel {worst:.2e} (limit "
          f"{rtol:g}) where the gradients determine the step; {past} of {total} "
          f"elements past {rtol:g} of scale in all; share of each leaf whose step "
          f"they do not determine, held to Adam's 2·lr bound: {json.dumps(exempt)}")
    return shares


def leaf_errs(got, want) -> tuple[float, int]:
    """(worst rel err of ``got``'s leaves against ``want``'s, the number of
    leaves that are bit-equal)."""
    import torch

    from repro_torch.models import model

    worst, same = 0.0, 0
    for a, b in zip(model.tree_leaves(got), model.tree_leaves(want), strict=True):
        b = b.to(a.device)
        worst = max(worst, rel_err(a, b)[1])
        same += bool(torch.equal(a, b))
    return worst, same


def train_checks(dev, base) -> dict:
    """TRAIN_CHECK at full width cut to its layers: remat variants, the
    microbatch step, card against CPU, and kill and resume."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.data import TokenStream
    from repro_torch.launch import train
    from repro_torch.models import LayerSpec, model
    from repro_torch.optim import AdamW

    c = TRAIN_CHECK
    cut = dataclasses.replace(base, stages=((c["layers"], base.stages[0][1]),))
    opt = AdamW(lr=TRAIN["lr"], weight_decay=TRAIN["weight_decay"], grad_clip=TRAIN["clip"])
    params = model.init_params(cut, seed=TRAIN["seed"] + 1, device=dev)
    batch = train.batch_to(TokenStream(cut.vocab_size, TRAIN["batch"], TRAIN["seq"],
                                       seed=TRAIN["seed"]).next_batch(), dev)
    out: dict = {}

    # Remat: the same loss and gradients, the kernels re-launched.
    ref = None
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(cut, remat=remat)
        c0 = counts_now()
        loss, _, grads = train.loss_and_grads(params, cfg, batch)
        sync(dev)
        got = launched(c0)
        want = lm_launches(cfg, "train")
        expect((got.get("flash_attention"), got.get("rmsnorm")) == want,
               f"train remat {remat}: launched {got}, expected (flash, rmsnorm) {want}")
        if ref is None:
            ref = (loss, grads)
            print(f"[train] remat none at {c['layers']} layers: loss {float(loss):.6f}, "
                  f"launches {json.dumps(got)}")
            continue
        worst, same = leaf_errs(grads, ref[1])
        n = len(model.tree_leaves(grads))
        loss_same = bool(torch.equal(loss, ref[0]))
        print(f"[train] remat {remat} against none: loss "
              f"{'bit-equal' if loss_same else f'rel {rel_err(loss, ref[0])[1]:.2e}'}, "
              f"{same} of {n} gradient leaves bit-equal, worst rel {worst:.2e}; "
              f"launches {json.dumps(got)}")
        expect(loss_same and same == n,
               f"train remat {remat}: not bit-equal to none (loss {loss_same}, "
               f"{same}/{n} leaves, worst rel {worst:.2e})")
        out[remat] = dict(worst=worst, same=same)
        del grads
    del ref
    torch.cuda.empty_cache()

    # Microbatches 2 against 1, float32, from one state.
    cfg32 = dataclasses.replace(cut, dtype="float32")
    fresh = lambda: train.TrainState(model.tree_map(torch.clone, params),  # noqa: E731
                                     opt.init(params), 0)
    one, _ = train.make_train_step(cfg32, opt, 1)(fresh(), batch)
    two, _ = train.make_train_step(cfg32, opt, 2)(fresh(), batch)
    worst_mu, _ = leaf_errs(two.opt_state.mu, one.opt_state.mu)
    worst_nu, _ = leaf_errs(two.opt_state.nu, one.opt_state.nu)
    expect(max(worst_mu, worst_nu) <= c["micro_rtol"],
           f"train microbatches: mu rel {worst_mu:.2e}, nu rel {worst_nu:.2e}")
    # μ after one step is (1 − b1) times the clipped gradient.
    g_one, g_two = (model.tree_map(lambda m: m / (1 - opt.b1), st.opt_state.mu)
                    for st in (one, two))
    print(f"[train] microbatches 2 vs 1 (float32, {TRAIN['batch']} x {TRAIN['seq']} "
          f"tokens): mu rel {worst_mu:.2e}, nu rel {worst_nu:.2e} (limit "
          f"{c['micro_rtol']:g})")
    out["micro_exempt"] = adam_step_check("microbatches 2 vs 1", two.params, one.params,
                                          g_two, g_one, opt.lr, c["micro_rtol"])
    del one, two, g_one, g_two, params, batch
    torch.cuda.empty_cache()

    # One step on the card against the CPU: float32, window 512.
    cfg = dataclasses.replace(
        cut, dtype="float32", cache_dtype="float32",
        stages=((c["layers"], (LayerSpec(kind="attn", window=c["window"]),)),))
    params = model.init_params(cfg, seed=TRAIN["seed"] + 2, device=dev)
    host = TokenStream(cfg.vocab_size, c["cpu_batch"], c["cpu_seq"],
                       seed=TRAIN["seed"] + 2).next_batch()
    res = {}
    for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
        p = params if label == "card" else model.tree_map(lambda a: a.cpu(), params)
        t0 = time.perf_counter()
        loss, _, grads = train.loss_and_grads(p, cfg, train.batch_to(host, d))
        new, st = opt.update(grads, opt.init(p), p)
        sync(dev)
        # μ after one step is (1 − b1) times the clipped gradient.
        clipped = model.tree_map(lambda m: m / (1 - opt.b1), st.mu)
        res[label] = (loss, grads, new, time.perf_counter() - t0, clipped)
    loss_rel = rel_err(res["card"][0].cpu(), res["cpu"][0])[1]
    worst, _ = leaf_errs(res["card"][1], res["cpu"][1])
    expect(loss_rel <= c["cpu_rtol"] and worst <= c["cpu_rtol"],
           f"train card vs CPU: loss rel {loss_rel:.2e}, gradients rel {worst:.2e}")
    print(f"[train] one step card vs CPU ({c['layers']} layers at full width, float32, "
          f"window {c['window']}, {c['cpu_batch']} x {c['cpu_seq']} tokens; card "
          f"{res['card'][3]:.2f} s, CPU {res['cpu'][3]:.2f} s): loss rel {loss_rel:.2e}, "
          f"gradients worst rel {worst:.2e} (limit {c['cpu_rtol']:g})")
    out["cpu_exempt"] = adam_step_check("card vs CPU", res["card"][2], res["cpu"][2],
                                        res["card"][4], res["cpu"][4], opt.lr, c["cpu_rtol"])
    del res, params
    torch.cuda.empty_cache()

    # train_loop stopped after its step-3 checkpoint, resumed to 6.
    kw = dict(global_batch=c["resume_batch"], seq_len=c["resume_seq"], seed=TRAIN["seed"],
              lr=TRAIN["lr"], device=dev)
    t0 = time.perf_counter()
    straight, _ = train.train_loop(cut, steps=c["resume_steps"], **kw)
    straight_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
        t0 = time.perf_counter()
        first, _ = train.train_loop(cut, steps=c["kill_at"], ckpt_dir=d,
                                    ckpt_every=c["kill_at"], **kw)
        del first
        torch.cuda.empty_cache()
        resumed, hist = train.train_loop(cut, steps=c["resume_steps"], ckpt_dir=d,
                                         ckpt_every=c["kill_at"], **kw)
        ckpt_s = time.perf_counter() - t0
    expect(resumed.step == c["resume_steps"], f"train resume reached {resumed.step}")
    want = dict(paths_of(straight.params))
    worst, same, n = 0.0, 0, 0
    for path, leaf in paths_of(resumed.params):
        worst = max(worst, rel_err(leaf, want[path])[1])
        same += bool(torch.equal(leaf, want[path]))
        n += 1
    expect(worst <= c["resume_rtol"], f"train resume: rel {worst:.2e}")
    print(f"[train] train_loop stopped after its step-{c['kill_at']} checkpoint and "
          f"resumed to {c['resume_steps']} ({c['resume_batch']} x {c['resume_seq']} "
          f"tokens, {ckpt_s:.1f} s with two checkpoints and a restore, against "
          f"{straight_s:.1f} s straight): params worst rel {worst:.2e} (limit "
          f"{c['resume_rtol']:g}), {same} of {n} leaves bit-equal")
    out["resume"] = dict(worst=worst, same=same)
    del straight, resumed
    torch.cuda.empty_cache()
    return out


def paths_of(tree, pre=""):
    """(path, leaf) of a nested dict/list of tensors."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from paths_of(v, f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from paths_of(v, f"{pre}/{i}")
    else:
        yield pre, tree


def phase_train(dev) -> dict:
    """LM training on TRAIN's config at its published width and depth, then
    train_checks at two layers."""
    import torch

    from repro_torch import configs
    from repro_torch.data import TokenStream
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.optim import AdamW

    c = TRAIN
    cfg = configs.get_config(c["arch"])
    opt = AdamW(lr=c["lr"], weight_decay=c["weight_decay"], grad_clip=c["clip"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = train.init_state(cfg, c["seed"], opt, dev)
    n_params = sum(t.numel() for t in model.tree_leaves(state.params))
    sync(dev)
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}: {n_params / 1e9:.3f} B params; "
          f"{cfg.dtype} activations, remat {cfg.remat!r}, float32 params/mu/nu "
          f"({mib(12 * n_params)} MiB) updated in place; init "
          f"{time.perf_counter() - t0:.1f} s")
    stream = TokenStream(cfg.vocab_size, c["batch"], c["seq"], seed=c["seed"])
    fixed = train.batch_to(stream.next_batch(), dev)
    step = train.make_train_step(cfg, opt)
    want_flash, want_norm = lm_launches(cfg, "train")
    tc = flash_ops.TENSOR_CORE
    losses, walls = [], []

    def one(batch):
        nonlocal state
        c0 = counts_now()
        sync(dev)
        t = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        sync(dev)
        walls.append(time.perf_counter() - t)
        got = launched(c0)
        expect(math.isfinite(loss) and math.isfinite(float(m["grad_norm"])),
               f"train: step {len(losses)} loss {loss}")
        expect(got.get("flash_attention") == want_flash and got.get(tc) == want_flash
               and got.get("rmsnorm") == want_norm,
               f"train: a step launched {got}; expected {want_flash} flash (all on "
               f"the tensor cores) and {want_norm} rmsnorm")
        losses.append(loss)
        return got

    reset_counts()
    t0 = time.perf_counter()
    for _ in range(c["warm"] + c["timed"]):
        per_step = one(fixed)
    for _ in range(c["stream"]):
        one(train.batch_to(stream.next_batch(), dev))
    run_s = time.perf_counter() - t0
    counts = counts_now()
    peak = torch.cuda.max_memory_allocated(dev)
    gate_counts("train", counts, ("flash_attention", tc, "rmsnorm"))
    n_fit = c["warm"] + c["timed"]
    expect(losses[n_fit - 1] < losses[0], f"train: the overfit loss did not fall {losses}")
    tokens = c["batch"] * c["seq"]
    timed = walls[c["warm"]:n_fit]
    step_s = float(np.median(timed))
    print(f"[train] {len(losses)} steps in {run_s:.1f} s; losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f" (overfit {losses[0]:.4f} -> {losses[n_fit - 1]:.4f}, then the stream)")
    print(f"[train] step ms: first {walls[0] * 1e3:.1f}, warm median "
          f"{step_s * 1e3:.1f} (of {c['timed']}: min {min(timed) * 1e3:.1f}, max "
          f"{max(timed) * 1e3:.1f}); {tokens / step_s:.0f} tokens/s at "
          f"{c['batch']} x {c['seq']}; max_memory_allocated {peak / 2**20:.0f} MiB "
          f"(in-place AdamW update); launches per step {json.dumps(per_step)}")
    busy = profile_busy(f"train step ({c['batch']} x {c['seq']} tokens)",
                        lambda: one(fixed), dev, step_s)
    top = top_ops("train step", lambda: one(fixed), dev)
    gemm = 6 * n_params * tokens
    # Causal attention: q·k and p·v over S(S+1)/2 pairs per head, 2 FLOPs a
    # multiply-add, forward once, recomputed once under remat, and the
    # backward's four products.
    attn = 2 * 2 * cfg.resolved_head_dim * cfg.n_heads * c["batch"] * (
        c["seq"] * (c["seq"] + 1) // 2) * cfg.n_layers * (1 + 1 + 2)
    print(f"[timing] train step: model FLOPs 6·N·tokens = {gemm:.3e} (bf16 GEMMs) + "
          f"{attn:.3e} attention (forward, recompute, backward); "
          f"{gemm / step_s / 1e12:.1f} TFLOP/s of GEMM work = "
          f"{100 * gemm / step_s / BF16_TC_FLOP_PER_S:.1f}% of the bf16 dense peak "
          f"({BF16_TC_FLOP_PER_S / 1e12:.0f} TFLOP/s)")
    del state, fixed
    torch.cuda.empty_cache()
    checks = train_checks(dev, cfg)
    return dict(counts=counts, per_step=per_step, losses=losses, walls=walls,
                step_s=step_s, tokens_s=tokens / step_s, peak=peak, busy=busy,
                top=top, checks=checks, n_params=n_params)


def top_ops(label: str, fn, dev, n: int = 8) -> list:
    """Profile one call of ``fn`` and print its PyTorch ops by the device
    time of the kernels each launched itself (self device time), largest
    first, with their share of the call's device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync(dev)
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if e.device_type == DeviceType.CPU and t > 0:
            rows.append((e.key, t / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    if not total:
        print(f"[timing] {label}: the profiler saw no device time (not measured)")
        return []
    print(f"[timing] {label}: top ops by self device time ({total:.1f} ms in all): "
          + "; ".join(f"{k} {t:.1f} ms ({100 * t / total:.0f}%, {c} calls)"
                      for k, t, c in rows[:n]))
    return rows[:n]


def arch_inputs(cfg, batch: int, seq: int, dev, seed: int) -> dict:
    """Random token ids [batch, seq] and the config's stub inputs (float32
    frame or patch embeddings) on the card."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                                   device=dev)}
    if cfg.n_enc_layers:
        out["enc_input"] = torch.randn((batch, cfg.enc_seq, cfg.d_model),
                                       generator=gen, device=dev)
    if cfg.n_vis_tokens:
        out["vis_input"] = torch.randn((batch, cfg.n_vis_tokens, cfg.d_model),
                                       generator=gen, device=dev)
    return out


def arch_check(dev, cfg, params, label) -> float:
    """Decode against forward in float32 at ARCHS' check sizes; returns the
    worst rel err (deepseek: naive and absorbed)."""
    import dataclasses

    import torch

    from repro_torch.models import model

    a = ARCHS
    cfg32 = dataclasses.replace(cfg, dtype="float32", cache_dtype="float32",
                                capacity_factor=8.0)
    n = a["check_prompt"] + a["check_steps"]
    ins = arch_inputs(cfg32, 1, n, dev, a["seed"] + 1)
    tok = ins.pop("tokens")
    full, _ = model.forward(params, cfg32, tok, **ins)
    worst = 0.0
    forms = [cfg32] + ([dataclasses.replace(cfg32, mla_absorb=True)]
                       if cfg.kv_lora_rank else [])
    for form in forms:
        first, cache = model.prefill(params, form, tok[:, :a["check_prompt"]],
                                     max_len=n, **ins)
        outs = [first]
        for i in range(a["check_prompt"], n):
            lg, cache = model.decode_step(params, cache, form, tok[:, i:i + 1], i)
            outs.append(lg[:, 0])
        err, rel = rel_err(torch.stack(outs, 1), full[:, a["check_prompt"] - 1:])
        expect(rel <= a["check_rtol"], f"{label}: decode vs forward rel {rel:.2e}")
        print(f"[lm-archs] {label}: float32 prefill({a['check_prompt']}) + "
              f"{a['check_steps']} decode steps vs forward"
              f"{' (mla_absorb)' if form.mla_absorb else ''}: max abs {err:.3e}, "
              f"rel {rel:.2e} (limit {a['check_rtol']:g})")
        worst = max(worst, rel)
    return worst


def arch_run(dev, arch: str, total: dict) -> dict:
    """One config of ARCHS: prefill, decode, the f32 check and a train step."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.data import TokenStream
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.optim import AdamW

    a = ARCHS
    base = configs.get_config(arch)
    cfg = base if arch in a["whole"] else dataclasses.replace(
        base, stages=tuple((1, p) for _, p in base.stages))
    cut = ("none (runs whole)" if cfg is base else
           " + ".join(f"{r} -> 1 x {len(p)}" for r, p in base.stages))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init_params(cfg, seed=a["seed"], device=dev)
    n_params = sum(t.numel() for t in model.tree_leaves(params))
    kinds = sorted({s.kind for _, p in cfg.stages for s in p}
                   | ({"encoder"} if cfg.n_enc_layers else set())
                   | ({"moe"} if cfg.n_experts else set()))
    print(f"[lm-archs] {arch}: d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads of {cfg.resolved_head_dim}, vocab {cfg.vocab_size}; depth cut: "
          f"{cut} ({cfg.n_layers} of {base.n_layers} layers"
          f"{f', encoder {cfg.n_enc_layers} layers' if cfg.n_enc_layers else ''}); "
          f"{n_params / 1e9:.3f} B params; kinds {', '.join(kinds)}")

    def part(label, fn, want):
        reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        res = fn()
        sync(dev)
        wall = time.perf_counter() - t0
        counts = counts_now()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        got = (counts["flash_attention"], counts["rmsnorm"])
        expect(got == want, f"{arch} {label}: launched (flash, rmsnorm) {got}, "
               f"expected {want}")
        return res, wall, {k: v for k, v in counts.items() if v}

    s = a["prompts"].get(arch, a["prompt"])
    ins = arch_inputs(cfg, a["batch"], s, dev, a["seed"])
    tok = ins.pop("tokens")
    max_len = s + a["new"]
    fill = lambda: model.prefill(params, cfg, tok, max_len=max_len, **ins)  # noqa: E731
    (logits, cache), first_s, fill_counts = part("prefill", fill,
                                                 lm_launches(cfg, "prefill"))
    expect(bool(torch.isfinite(logits).all()), f"{arch}: non-finite prefill logits")
    del cache
    (logits, cache), warm_s, _ = part("prefill", fill, lm_launches(cfg, "prefill"))
    steps = []
    want = lm_launches(cfg, "decode")
    nxt = logits.argmax(-1)[:, None]
    for i in range(a["new"]):
        (lg, cache), wall, step_counts = part(
            "decode", lambda: model.decode_step(params, cache, cfg, nxt, s + i), want)
        expect(bool(torch.isfinite(lg).all()), f"{arch}: non-finite decode logits")
        nxt = lg[:, 0].argmax(-1)[:, None]
        steps.append(wall)
    del cache, logits, lg
    peak = torch.cuda.max_memory_allocated(dev)
    step = float(np.median(steps))
    print(f"[lm-archs] {arch}: prefill {a['batch']} x {s} tokens first "
          f"{first_s * 1e3:.1f} ms, warm {warm_s * 1e3:.1f} ms (launches "
          f"{json.dumps(fill_counts)}); decode {a['new']} steps at batch "
          f"{a['batch']}: median {step * 1e3:.2f} ms/step (launches "
          f"{json.dumps(step_counts)}); peak {peak / 2**20:.0f} MiB")
    out = dict(params=n_params, prefill_first=first_s, prefill_warm=warm_s,
               decode=step, peak=peak, counts=fill_counts)
    out["check"] = arch_check(dev, cfg, params, arch)
    if arch in a["no_train"]:
        print(f"[lm-archs] {arch}: no train step on one card: its one-repeat "
              f"train state is {n_params / 1e9:.2f} B params x 16 bytes = "
              f"{16 * n_params / 1e9:.0f} GB (the reduced config trains in the gpu "
              f"tests)")
        return out
    opt = AdamW(lr=1e-3, weight_decay=0.01, grad_clip=1.0)
    state = train.TrainState(params, opt.init(params), 0)
    del params
    batch = train.batch_to(TokenStream(
        cfg.vocab_size, a["train_batch"], a["train_seq"], seed=a["seed"],
        enc_seq=cfg.enc_seq, n_vis_tokens=cfg.n_vis_tokens,
        d_model=cfg.d_model).next_batch(), dev)
    step_fn = train.make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats(dev)
    (state, m), train_s, train_counts = part(
        "train step", lambda: step_fn(state, batch), lm_launches(cfg, "train"))
    loss = float(m["loss"])
    expect(math.isfinite(loss) and math.isfinite(float(m["grad_norm"])),
           f"{arch}: train step loss {loss}, grad norm {float(m['grad_norm'])}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[lm-archs] {arch}: one train step ({a['train_batch']} x {a['train_seq']} "
          f"tokens, remat {cfg.remat!r}, in-place AdamW) {train_s * 1e3:.1f} ms (the "
          f"first), loss {loss:.4f}, grad norm {float(m['grad_norm']):.3e}; peak "
          f"{peak / 2**20:.0f} MiB; launches {json.dumps(train_counts)}")
    out.update(train_s=train_s, train_peak=peak, loss=loss)
    del state, batch
    return out


def phase_lm_archs(dev) -> dict:
    """ARCHS' nine configs, each with launch counts set to 0 before every
    call and gated after it."""
    import torch

    total: dict = {}
    out = {}
    for arch in ARCHS["names"]:
        t0 = time.perf_counter()
        out[arch] = arch_run(dev, arch, total)
        torch.cuda.empty_cache()
        print(f"[lm-archs] {arch} done in {time.perf_counter() - t0:.1f} s")
    gate_counts("lm-archs", total, ("flash_attention", "rmsnorm"))
    return dict(counts=total, archs=out)


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
# Phase 15: resilience
# --------------------------------------------------------------------------


def resilience_problem(dev):
    """The resilience op stream at the serving width: the empty capacity-128
    state of the serving phase, five observe batches of 32 nodes (160, so
    the last batch runs past capacity), and the query nodes."""
    from repro_torch import serving

    graph, wcfg, f, seed, *_ = serving_problem(SERVE, dev)
    empty = serving.init_state(graph, seed, f, SERVE["sigma_n2"],
                               SERVE["capacity"], wcfg)
    rng = np.random.default_rng(RESIL["seed"])
    n_obs = RESIL["batches"] * RESIL["batch"]
    nodes = rng.choice(SERVE["n_nodes"], n_obs + RESIL["n_query"],
                       replace=False).astype(np.int32)
    obs_nodes = nodes[:n_obs].reshape(RESIL["batches"], RESIL["batch"])
    ys = rng.standard_normal(obs_nodes.shape).astype(np.float32)
    return empty, obs_nodes, ys, nodes[n_obs:]


def resilience_ops(srv, problem) -> None:
    """The journalled op stream: five observe batches, one forget and one
    refit(f·1.02) — seven kill points."""
    empty, obs_nodes, ys, _ = problem
    for nodes, y in zip(obs_nodes, ys):
        srv.observe(nodes, y)
    srv.forget(RESIL["forget_slot"])
    srv.refit(f=empty.f * 1.02)


_RESIL_CHILD = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import torch
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
from repro_torch.resilience import ResilientServer

chip_smoke.SERVE.update({serve!r})   # the parent's op stream, as it ran there
chip_smoke.RESIL.update({resil!r})
problem = chip_smoke.resilience_problem(torch.device({device!r}))
srv = ResilientServer(problem[0], journal={jpath!r}, checkpoint_dir={cdir!r},
                      checkpoint_every={every}, on_overflow="forget_oldest")
chip_smoke.resilience_ops(srv, problem)
raise SystemExit("kill_at never fired")
"""


def _escalation_counters(obs) -> dict:
    c = obs.REGISTRY.snapshot()["counters"]
    return {k: c.get(f"solver.escalation.{k}", 0)
            for k in ("attempts", "resolved", "forced_stalls", "exhausted")}


def _quantiles_ms(samples) -> str:
    a = np.asarray(samples) * 1e3
    return f"p50 {np.percentile(a, 50):.3f} ms, p99 {np.percentile(a, 99):.3f} ms"


def phase_resilience(dev) -> dict:
    """Fault injection, the escalation ladder, the journal, ResilientServer
    and the checkpoint manager at the serving width (K = 144, capacity 128)
    and on the solvers phase's clustered block (T = 4000)."""
    import os
    import tempfile

    import torch

    from repro_torch import obs, serving, solvers
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.resilience import (KILL_EXIT_CODE, Journal, ResilientServer,
                                        faults, read_journal, recover)
    from repro_torch.serving import update

    total: dict = {}

    def part(label, need, fn):
        reset_counts()
        out = fn()
        sync(dev)
        counts = counts_now()
        gate_counts(label, counts, need)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return out

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_resilience_")
    try:
        problem = resilience_problem(dev)
        empty, obs_nodes, _, query = problem
        plan = faults.parse_faults(RESIL["plan"])
        print(f"[resilience] chaos plan [{plan.spec()}]")

        # 1. Chaos serving: the journalled server under the plan, then the
        # escalated refit_alpha and the engine over the query nodes.
        def chaos():
            jpath = os.path.join(tmp.name, "chaos.jsonl")
            with faults.use_faults(plan):
                t0 = time.perf_counter()
                srv = ResilientServer(empty, journal=jpath,
                                      checkpoint_dir=os.path.join(tmp.name, "chaos"),
                                      checkpoint_every=RESIL["checkpoint_every"],
                                      on_overflow="forget_oldest")
                resilience_ops(srv, problem)
                sync(dev)
                ops_s = time.perf_counter() - t0
                obs.REGISTRY.reset()
                with obs.tap_scope(True):
                    st = update.refit_alpha(srv.state, escalate=True,
                                            return_diagnostics=True)
                    esc = _escalation_counters(obs)
                obs.REGISTRY.reset()
                srv.state = st[0]
                reqs = [serving.GPRequest(nodes=query[i:i + SERVE["req"]])
                        for i in range(0, len(query), SERVE["req"])]
                serving.GPServeLoop(srv.state, batch=SERVE["batch"]).run(reqs)
            srv.close()
            return srv, st, esc, reqs, ops_s

        srv, (_, iters, conv), esc, reqs, ops_s = part(
            "resilience chaos", ("walk_sampler", "gram_block"), chaos)
        s = srv.state
        poisoned = faults._hash01(torch.from_numpy(obs_nodes.reshape(-1)), plan.seed)
        expected = int((poisoned < plan.nan_payload + plan.inf_payload).sum())
        expect(expected > 0, "the chaos stream poisons no append")
        expect(int(s.rejected) == expected,
               f"rejected {int(s.rejected)} != {expected} poisoned appends")
        expect(bool(torch.isfinite(s.chol).all()), "chaos left a non-finite Cholesky")
        expect(conv and esc == dict(attempts=2, resolved=1, forced_stalls=1,
                                    exhausted=0),
               f"refit_alpha ladder under cg_stall:1: converged {conv}, {esc}")
        expect(all(r.done for r in reqs), "chaos: unanswered queries")
        mean = np.concatenate([r.mean for r in reqs])
        var = np.concatenate([r.var for r in reqs])
        expect(len(mean) == len(query) and np.isfinite(mean).all()
               and np.isfinite(var).all() and (var >= 0).all(),
               "chaos: a query answered non-finitely")
        sanitized = int((faults._hash01(torch.from_numpy(query), plan.seed)
                         < plan.nan_payload + plan.inf_payload).sum())
        print(f"[resilience] chaos: 7 journalled ops in {ops_s * 1e3:.1f} ms, "
              f"{expected} poisoned appends rejected (of {obs_nodes.size}), count "
              f"{int(s.count)}, overflow {int(s.overflow)}, finite Cholesky; "
              f"refit_alpha resolved in one extra rung ({iters} iterations, {esc}); "
              f"{len(query)} queries answered finitely ({sanitized} poisoned rows "
              f"sanitised to the prior)")

        # Query latency: requests of 16 nodes through the server's query,
        # the plan on and off in turns, on the chaos state.
        lat: dict = {"chaos": [], "fault-free": []}
        q_reqs = [torch.from_numpy(query[i:i + SERVE["req"]]).to(dev)
                  for i in range(0, len(query), SERVE["req"])]
        for rnd in range(2 * RESIL["latency_rounds"]):
            mode = ("chaos", "fault-free")[rnd % 2]
            with faults.use_faults(plan if mode == "chaos" else None):
                for q in q_reqs:
                    t0 = time.perf_counter()
                    m, v = srv.query(q)
                    sync(dev)
                    lat[mode].append(time.perf_counter() - t0)
        print(f"[resilience] query latency, {len(q_reqs)} requests of "
              f"{SERVE['req']} nodes x {RESIL['latency_rounds']} rounds each, in "
              f"turns: chaos {_quantiles_ms(lat['chaos'])}; fault-free "
              f"{_quantiles_ms(lat['fault-free'])}")

        # Journal cost alone: one 32-node observe record per op.
        with Journal(os.path.join(tmp.name, "bench.jsonl")) as j:
            nodes_l, ys_l = obs_nodes[0].tolist(), [0.5] * RESIL["batch"]
            t0 = time.perf_counter()
            for _ in range(RESIL["journal_ops"]):
                j.log("observe", nodes=nodes_l, ys=ys_l, on_overflow="reject",
                      auto_refit=True)
            journal_us = (time.perf_counter() - t0) / RESIL["journal_ops"] * 1e6
        print(f"[resilience] journal: {journal_us:.1f} us per 32-node observe "
              f"record (flush, no fsync; {RESIL['journal_ops']} records)")

        # 2. Kill and recover: the op stream in a child process on the card,
        # killed at its kill_at-th op (after the checkpoint of op 4, before
        # that of op 6), recovered here from checkpoint + journal tail.
        jpath = os.path.join(tmp.name, "kill.jsonl")
        cdir = os.path.join(tmp.name, "kill")
        child = _RESIL_CHILD.format(src=str(SRC), root=str(ROOT), jpath=jpath,
                                    cdir=cdir, every=RESIL["checkpoint_every"],
                                    serve=SERVE, resil=RESIL, device=str(dev))
        env = dict(os.environ, REPRO_FAULTS=f"kill_at:{RESIL['kill_at']}")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", child], env=env,
                              capture_output=True, text=True, timeout=300)
        child_s = time.perf_counter() - t0
        expect(proc.returncode == KILL_EXIT_CODE,
               f"killed child exited {proc.returncode}, not {KILL_EXIT_CODE}: "
               f"{proc.stderr[-2000:]}")
        events = read_journal(jpath)
        expect(len(events) == RESIL["kill_at"]
               and [e["type"] for e in events] == ["observe"] * RESIL["kill_at"],
               f"journal after the kill: {[e['type'] for e in events]}")

        def recovery():
            t0 = time.perf_counter()
            st, n_tail = recover(empty, jpath, cdir)
            sync(dev)
            t1 = time.perf_counter()
            st_full, n_full = recover(empty, jpath, None)
            sync(dev)
            t2 = time.perf_counter()
            ref = ResilientServer(empty, on_overflow="forget_oldest")
            for nodes, y in zip(obs_nodes[:RESIL["kill_at"]],
                                problem[2][:RESIL["kill_at"]]):
                ref.observe(nodes, y)
            return st, n_tail, t1 - t0, st_full, n_full, t2 - t1, ref.state

        st, n_tail, rec_s, st_full, n_full, full_s, ref = part(
            "resilience recover", ("walk_sampler", "gram_block"), recovery)
        expect(0 < n_tail < n_full == RESIL["kill_at"],
               f"replayed {n_tail} of {n_full} events")
        qm = torch.from_numpy(query[:SERVE["n_moments"]]).to(dev)
        errs = []
        for other in (ref, st_full):
            for a, b in zip(serving.posterior_moments(st, qm),
                            serving.posterior_moments(other, qm)):
                errs.append(rel_err(a, b)[1])
        expect(max(errs) <= 1e-5, f"recovered moments off by {max(errs):.2e} of scale")
        print(f"[resilience] kill_at:{RESIL['kill_at']}: child exit "
              f"{proc.returncode} in {child_s:.1f} s, journal {len(events)} ops; "
              f"recover from checkpoint + {n_tail}-event tail {rec_s * 1e3:.1f} ms; "
              f"full replay of {n_full} events {full_s * 1e3:.1f} ms "
              f"({full_s * 1e3 / n_full:.1f} ms per event); moments on "
              f"{SERVE['n_moments']} nodes within {max(errs):.2e} of scale of the "
              "uninterrupted run and of the full replay")

        # 3. The escalated solve on the clustered block.
        _, _, _, _, _, _, h, b = solver_problem(SOLVE, dev)
        x_none = solvers.solve(h, b, solve_strategy("none")).x
        rung_ms: list = []
        seen: list = []
        real = solvers.escalate._base_solve

        def timed_rung(*a, **k):
            sync(dev)
            t0 = time.perf_counter()
            res = real(*a, **k)
            sync(dev)
            rung_ms.append((time.perf_counter() - t0) * 1e3)
            seen.append(res)
            return res

        def escalated(spec):
            obs.REGISTRY.reset()
            rung_ms.clear()
            seen.clear()
            solvers.escalate._base_solve = timed_rung
            try:
                with faults.use_faults(spec), obs.tap_scope(True):
                    res = solvers.solve(h, b, solve_strategy("nystrom"),
                                        escalate=True)
                    esc = _escalation_counters(obs)
            finally:
                solvers.escalate._base_solve = real
                obs.REGISTRY.reset()
            return res, esc, list(rung_ms), list(seen)

        res, esc, ms1, _ = part("resilience escalate",
                                ("khat_fused", "gram_block", "woodbury_apply"),
                                lambda: escalated("cg_stall:1"))
        _, rel = rel_err(res.x, x_none)
        expect(bool(res.converged.all()) and rel <= 1e-4
               and esc == dict(attempts=2, resolved=1, forced_stalls=1, exhausted=0),
               f"escalated solve under cg_stall:1: converged "
               f"{bool(res.converged.all())}, rel {rel:.2e} to 'none', {esc}")
        res9, esc9, ms9, seen9 = part("resilience exhaust",
                                      ("khat_fused", "woodbury_apply"),
                                      lambda: escalated("cg_stall:9"))
        best = min(seen9, key=lambda r: float(r.resnorm.max()))
        expect(not bool(res9.converged.any()) and esc9["exhausted"] == 1
               and torch.equal(res9.x, best.x),
               f"exhausted ladder under cg_stall:9: {esc9}, converged "
               f"{bool(res9.converged.any())}")
        print(f"[resilience] escalated nystrom solve (T = {b.shape[0]}): "
              f"cg_stall:1 converged in {len(ms1)} attempts ({esc}), rel "
              f"{rel:.2e} to 'none', rung ms " + ", ".join(f"{m:.1f}" for m in ms1)
              + f"; cg_stall:9 exhausted after {len(ms9)} attempts ({esc9}), best "
              f"iterate returned, rung ms " + ", ".join(f"{m:.1f}" for m in ms9))

        # 4. Checkpoints: the capacity-128 serving state and a BO run.
        mgr = CheckpointManager(os.path.join(tmp.name, "state"), keep=2)
        packed = update._pack(s)
        t0 = time.perf_counter()
        mgr.save(1, packed, extra={"journal_seq": 6})
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        mgr.save(2, packed, blocking=False)
        async_call_ms = (time.perf_counter() - t0) * 1e3
        mgr.wait()
        async_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back, _ = mgr.restore(update._pack(empty))
        sync(dev)
        restore_ms = (time.perf_counter() - t0) * 1e3
        flat_a = [x for x in _tensors(packed)]
        flat_b = [x for x in _tensors(back)]
        expect(len(flat_a) == len(flat_b) == 11 and all(
            a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(flat_a, flat_b)), "serving state restore not bit-equal")
        print(f"[resilience] serving state checkpoint: save {save_ms:.1f} ms "
              f"(blocking), async save returns in {async_call_ms:.1f} ms and lands "
              f"in {async_ms:.1f} ms, restore {restore_ms:.1f} ms; bit-equal")

        bo = bo_resume(dev, os.path.join(tmp.name, "bo"), part)
        return dict(counts=total, rejected=expected, journal_us=journal_us,
                    save_ms=save_ms, restore_ms=restore_ms, recover_ms=rec_s * 1e3,
                    replay_ms_per_event=full_s * 1e3 / n_full, rung_ms=ms1,
                    lat=lat, bo=bo)
    finally:
        tmp.cleanup()


# --------------------------------------------------------------------------
# The fleet phase: async serving, the sharded state and the distributed GP
# --------------------------------------------------------------------------


def fleet_schedule(n: int, ticks: int, seed: int) -> list:
    """bench_serving_load.py's replayed op stream: per tick, appends, enough
    forgets to hold the live count at the watermark, and Poisson query
    requests, grouped by kind within the tick."""
    c = FLEET
    rng = np.random.default_rng(seed)
    sched, live = [], c["warm"]
    for _ in range(ticks):
        ops = []
        for _ in range(c["observes_per_tick"]):
            if live < c["capacity"]:
                ops.append(("observe", int(rng.integers(n)),
                            float(rng.standard_normal())))
                live += 1
        while live > c["live_hi"]:
            ops.append(("forget", 0))
            live -= 1
        for _ in range(rng.poisson(c["lam_queries"])):
            ops.append(("query", rng.choice(n, c["req"], replace=False)
                        .astype(np.int32)))
        sched.append(ops)
    return sched


def fleet_problem(dev):
    """The empty capacity-128 state of the fleet phase and its 64 warm
    observations, from seeds."""
    import torch

    from repro_torch import serving
    from repro_torch.core import modulation, walks
    from repro_torch.graphs import generators

    c = FLEET
    n = c["n_nodes"]
    graph = generators.ring(n, k=c["ring_k"], device=dev)
    wcfg = walks.WalkConfig(c["n_walkers"], c["p_halt"], c["l_max"])
    mod = modulation.diffusion(l_max=c["l_max"])
    seed = walks.walk_seed(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(n)
    warm_nodes = rng.choice(n, c["warm"], replace=False).astype(np.int32)
    warm_y = rng.standard_normal(c["warm"]).astype(np.float32)
    empty = serving.init_state(graph, seed, mod(mod.init(device=dev)),
                               c["sigma_n2"], c["capacity"], wcfg)
    return empty, warm_nodes, warm_y


def _scan_done(outstanding, lat, now):
    still = []
    for req, t_sub in outstanding:
        if req.done:
            lat.append(now - t_sub)
        else:
            still.append((req, t_sub))
    return still


def drive_sync(state, schedule, dev):
    """The synchronous baseline (bench_serving_load's `_drive_sync`): each
    mutation applied eagerly in arrival order, then the tick's queries in
    blocking waves.  A request's latency runs from its tick's start."""
    import torch

    from repro_torch import serving

    loop = serving.GPServeLoop(state, batch=FLEET["batch"],
                               generator=torch.Generator(device=dev).manual_seed(5))
    outstanding, lat, reqs = [], [], []
    t0 = time.perf_counter()
    for ops in schedule:
        t_tick = time.perf_counter()
        for kind, *payload in ops:
            if kind == "observe":
                loop.state = serving.observe(loop.state, payload[0], payload[1],
                                             on_overflow="reject")
            elif kind == "forget":
                loop.state = serving.forget(loop.state, payload[0])
                sync(dev)
            else:
                req = serving.GPRequest(nodes=payload[0])
                reqs.append(req)
                outstanding.append((req, t_tick))
                loop.pending.append(req)
        while loop.pending or any(s is not None for s in loop.slots):
            while loop.pending and loop.admit(loop.pending[0]):
                loop.pending.popleft()
            loop.step()
            outstanding = _scan_done(outstanding, lat, time.perf_counter())
    sync(dev)
    return time.perf_counter() - t0, lat, reqs, loop.state


def drive_fleet(state, schedule, dev):
    """The overlapped fleet (bench_serving_load's `_drive_fleet`): the whole
    tick submitted up front, then steps until the tick's waves are reaped."""
    import torch

    from repro_torch import serving

    fleet = serving.GPFleetLoop(state, batch=FLEET["batch"],
                                generator=torch.Generator(device=dev).manual_seed(5),
                                max_pending=FLEET["max_pending"])
    outstanding, lat, reqs = [], [], []
    t0 = time.perf_counter()
    for ops in schedule:
        t_tick = time.perf_counter()
        for kind, *payload in ops:
            if kind == "observe":
                fleet.submit_observe([payload[0]], [payload[1]])
            elif kind == "forget":
                fleet.submit_forget(payload[0])
            else:
                req = serving.GPRequest(nodes=payload[0])
                reqs.append(req)
                while not fleet.submit(req):
                    fleet.step()
                    outstanding = _scan_done(outstanding, lat, time.perf_counter())
                outstanding.append((req, t_tick))
        fleet.step()
        while fleet._inflight is not None or any(s is not None for s in fleet.slots):
            fleet.step()
            outstanding = _scan_done(outstanding, lat, time.perf_counter())
        outstanding = _scan_done(outstanding, lat, time.perf_counter())
    while outstanding:
        fleet.step()
        outstanding = _scan_done(outstanding, lat, time.perf_counter())
    fleet.drain()
    sync(dev)
    return time.perf_counter() - t0, lat, reqs, fleet.serve_state


def fleet_kill_ops(fleet) -> None:
    """The JAX fleet chaos test's op stream at the fleet phase's width: six
    rounds of a 2-node observe (a forget in the third) and a 4-node query,
    each drained; kill_at 5 falls on the 4th observe."""
    from repro_torch import serving

    n = FLEET["n_nodes"]
    rng = np.random.default_rng(FLEET["seed"] + 1)
    for i in range(6):
        fleet.submit_observe(rng.integers(0, n, 2), rng.standard_normal(2))
        if i == 2:
            fleet.submit_forget(0)
        fleet.submit(serving.GPRequest(nodes=rng.integers(0, n, 4).astype(np.int32)))
        fleet.drain()


_FLEET_CHILD = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import torch
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
from repro_torch import serving
from repro_torch.resilience import Journal

chip_smoke.FLEET.update({fleet!r})   # the parent's configuration
empty, _, _ = chip_smoke.fleet_problem(torch.device({device!r}))
fleet = serving.GPFleetLoop(empty, batch=chip_smoke.FLEET["batch"],
                            journal=Journal({jpath!r}))
chip_smoke.fleet_kill_ops(fleet)
raise SystemExit("kill_at never fired")
"""


def host_profile(label: str, fn, top: int = 4) -> list:
    """cProfile one call of ``fn`` and print the functions with the most
    host time of their own, each with its share of the call's total."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    total = sum(v[2] for v in stats.values())
    rows = sorted(((v[2], f"{Path(k[0]).name}:{k[2]}") for k, v in stats.items()),
                  reverse=True)[:top]
    print(f"[host] {label}: {total * 1e3:.1f} ms of host time under cProfile; own "
          "time: " + "; ".join(f"{name} {t * 1e3:.1f} ms ({100 * t / total:.0f}%)"
                               for t, name in rows))
    return [(name, t, t / total) for t, name in rows]


def _latency(lat) -> tuple[float, float]:
    a = np.asarray(lat) * 1e3
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


def phase_fleet(dev) -> dict:
    """Async serving, the sharded serving state and the distributed GP at
    world size 1, and the fleet's kill-and-recover (see FLEET, DIST)."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import serving, solvers
    from repro_torch.core import linops, walks
    from repro_torch.distributed import gp_shard
    from repro_torch.launch import mesh as tmesh
    from repro_torch.resilience import KILL_EXIT_CODE, faults, read_journal, recover

    c = FLEET
    total: dict = {}
    t_phase = time.perf_counter()

    def part(label, need, fn, absent=()):
        reset_counts()
        out = fn()
        sync(dev)
        counts = counts_now()
        gate_counts(label, counts, need)
        for name in absent:
            expect(counts[name] == 0, f"{label} launched {name} {counts[name]} times")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return out

    empty, warm_nodes, warm_y = fleet_problem(dev)
    schedule = fleet_schedule(c["n_nodes"], c["ticks"], c["seed"])
    n_req = sum(op[0] == "query" for ops in schedule for op in ops)
    n_mut = sum(op[0] != "query" for ops in schedule for op in ops)
    drives = {"sync": drive_sync, "fleet": drive_fleet}

    def fresh():
        st = serving.ingest(empty, warm_nodes, warm_y)
        sync(dev)
        return st

    # 1. The traffic replay, sync loop against fleet, in turns.
    def replay():
        for fn in drives.values():
            fn(fresh(), schedule[:c["warm_ticks"]], dev)
        runs: dict = {}
        for name in c["order"]:
            runs.setdefault(name, []).append(drives[name](fresh(), schedule, dev))
        return runs

    runs = part("fleet replay", ("walk_sampler", "gram_block"), replay)
    want = runs["sync"][0][2]
    wm = np.concatenate([r.mean for r in want])
    wv = np.concatenate([r.var for r in want])
    stats = {}
    for name, reps in runs.items():
        rows = []
        for wall, lat, reqs, _ in reps:
            expect(len(reqs) == n_req and len(lat) == n_req
                   and all(r.done for r in reqs), f"fleet replay {name}: unanswered requests")
            for got, ref, what in ((np.concatenate([r.mean for r in reqs]), wm, "mean"),
                                   (np.concatenate([r.var for r in reqs]), wv, "var")):
                _, rel = rel_err(torch.from_numpy(got), torch.from_numpy(ref))
                expect(rel <= KERNEL_RTOL,
                       f"fleet replay {name}: {what} vs the sync loop rel {rel:.2e}")
            p50, p99 = _latency(lat)
            rows.append(dict(qps=n_req / wall, p50_ms=p50, p99_ms=p99, wall_s=wall))
        stats[name] = dict(reps=rows, qps=max(r["qps"] for r in rows),
                           p50_ms=min(r["p50_ms"] for r in rows),
                           p99_ms=min(r["p99_ms"] for r in rows))
        print(f"[fleet] {name}: {n_req} requests ({n_req * c['req']} nodes) and "
              f"{n_mut} mutations over {c['ticks']} ticks; per replay (in the order "
              f"{'/'.join(c['order'])}): " + "; ".join(
                  f"{r['qps']:.1f} requests/s, p50 {r['p50_ms']:.2f} ms, p99 "
                  f"{r['p99_ms']:.2f} ms, wall {r['wall_s']:.3f} s" for r in rows))
    ratio = stats["fleet"]["qps"] / stats["sync"]["qps"]
    print(f"[fleet] best of replays: fleet {stats['fleet']['qps']:.1f} vs sync "
          f"{stats['sync']['qps']:.1f} requests/s (ratio {ratio:.3f}); p99 "
          f"{stats['fleet']['p99_ms']:.2f} vs {stats['sync']['p99_ms']:.2f} ms; every "
          f"request's means and variances within {KERNEL_RTOL:g} of scale of the sync "
          "loop's")
    lo, hi = c["busy_ticks"]
    window = schedule[lo:hi]

    def advanced():
        """The state the loops hold at tick ``lo``: the earlier ticks'
        mutations applied eagerly."""
        st = fresh()
        for ops in schedule[:lo]:
            for kind, *payload in ops:
                if kind == "observe":
                    st = serving.observe(st, payload[0], payload[1], on_overflow="reject")
                elif kind == "forget":
                    st = serving.forget(st, payload[0])
        sync(dev)
        return st

    busy = {}
    for name, fn in drives.items():
        warm_s = fn(advanced(), window, dev)[0]
        st = advanced()
        busy[name] = profile_busy(f"fleet {name}, ticks {lo}-{hi - 1}",
                                  lambda fn=fn, st=st: fn(st, window, dev), dev, warm_s)
        busy[name]["warm_s"] = warm_s
        st = advanced()
        busy[name]["host"] = host_profile(f"fleet {name}, ticks {lo}-{hi - 1}",
                                          lambda fn=fn, st=st: fn(st, window, dev))
    print(f"[fleet] replay, warm-ups and busy windows in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    replay_state = runs["fleet"][-1][3]

    # 2 and 3 run under a one-rank process group: NCCL on the card (no two
    # ranks share a card), gloo when rehearsed on the CPU.
    store = tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{store.name}/pg",
                            world_size=1, rank=0)
    try:
        mesh = tmesh.make_serving_mesh()
        rng = np.random.default_rng(c["seed"] + 2)
        n = c["n_nodes"]

        def sharded():
            sh = serving.ShardedServeState(replay_state, mesh=mesh)
            single = replay_state
            checks = []

            def same(label, qnodes, one):
                for a, b, what in zip(sh.posterior_moments(qnodes),
                                      serving.posterior_moments(one, qnodes),
                                      ("mean", "var")):
                    expect(torch.equal(a, b), f"sharded {label} {what} not bit-equal "
                           f"(max diff {float((a - b).abs().max()):.3e})")
                checks.append(label)

            q = rng.choice(n, c["n_moments"], replace=False).astype(np.int32)
            same(f"moments on {len(q)} nodes", q, single)
            cand = rng.choice(n, c["n_cand"], replace=False).astype(np.int32)
            gen = lambda: torch.Generator(device=dev).manual_seed(7)  # noqa: E731
            expect(torch.equal(sh.thompson_draw(cand, gen(), n_samples=c["n_samples"]),
                               serving.thompson_draw(single, cand, gen(),
                                                     n_samples=c["n_samples"])),
                   "sharded Thompson draw not bit-equal")
            checks.append(f"{c['n_samples']}-sample Thompson draw on {len(cand)}")
            obs2 = rng.choice(n, 2, replace=False).astype(np.int32)
            one = serving.observe_batch(single, obs2, [0.5, -0.2])
            one = serving.forget_batch(serving.forget(one, 0), [1, 0])
            sh.observe_batch(obs2, [0.5, -0.2])
            sh.forget(0)
            sh.forget_batch([1, 0])
            same("after observe_batch / forget / forget_batch", q, one)
            with faults.use_faults("chol_fail:1"):
                one = serving.observe_batch(one, obs2[:1], [1.0])
                sh.observe_batch(obs2[:1], [1.0])
            expect(int(one.needs_refit) == 0 == int(sh.state.needs_refit),
                   "the refit fallback left needs_refit set")
            same("after a chol_fail:1 append and its refit", q, one)
            nodes = [rng.choice(n, c["req"], replace=False).astype(np.int32)
                     for _ in range(c["n_requests"])]
            gen9 = lambda: torch.Generator(device=dev).manual_seed(9)  # noqa: E731
            a = serving.GPServeLoop(one, batch=c["batch"], generator=gen9()).run(
                [serving.GPRequest(nodes=x) for x in nodes])
            b = serving.GPFleetLoop(serving.ShardedServeState(one, mesh=mesh),
                                    batch=c["batch"], generator=gen9()).run(
                [serving.GPRequest(nodes=x) for x in nodes])
            expect(all(x.done and y.done and all(
                np.array_equal(getattr(x, k), getattr(y, k)) for k in ("mean", "var", "draw"))
                for x, y in zip(a, b)), "fleet over the sharded state differs from "
                "the sync engine")
            checks.append(f"a fleet over it on {len(nodes)} requests of {c['req']} "
                          "(means, variances, draws)")
            return checks

        checks = part("fleet sharded", ("walk_sampler", "gram_block"), sharded)
        print(f"[fleet] ShardedServeState at world size 1 ({backend}): bit-equal to "
              "the single-device state: " + "; ".join(checks))

        # 3. The distributed GP on the main-path trace at N = 10⁶.
        graph, wcfg, f, train, y = make_problem(MAIN, dev)
        seed = walks.walk_seed(torch.Generator().manual_seed(7))
        strat = solvers.SHARDED_DEFAULT
        b = torch.randn(MAIN["n_nodes"], generator=torch.Generator(device=dev)
                        .manual_seed(11), device=dev)

        def reference():
            trace = walks.sample_walks(graph, seed, wcfg.n_walkers, wcfg.p_halt,
                                       wcfg.l_max)
            t0 = time.perf_counter()
            res = solvers.solve(linops.shifted(trace, f, DIST["sigma_n2"]), b, strat)
            sync(dev)
            return trace, res, time.perf_counter() - t0

        trace, ref, ref_s = part("fleet single-device solve", ("khat_fused",), reference)
        expect(bool(ref.converged.all()), "single-device solve did not converge")

        def sharded_gp():
            out = {}
            for label, fn in (
                ("sharded_cg_solve", lambda: gp_shard.sharded_cg_solve(
                    trace, f, b, mesh, sigma_n2=DIST["sigma_n2"], strategy=strat,
                    return_diagnostics=True)),
                ("sharded_cg_solve_chunked", lambda: gp_shard.sharded_cg_solve_chunked(
                    graph, f, b, mesh, seed, wcfg, chunk=DIST["chunk"],
                    sigma_n2=DIST["sigma_n2"], strategy=strat, return_diagnostics=True)),
                ("sharded_posterior_sample", lambda: gp_shard.sharded_posterior_sample(
                    trace, mask, f, y_full, torch.Generator(device=dev).manual_seed(5),
                    mesh, sigma_n2=DIST["sigma_n2"], return_diagnostics=True))):
                sync(dev)
                t0 = time.perf_counter()
                res = fn()
                sync(dev)
                out[label] = (*res, time.perf_counter() - t0)
            return out

        mask = torch.zeros(MAIN["n_nodes"], device=dev)
        mask[train.long()] = 1.0
        y_full = torch.zeros(MAIN["n_nodes"], device=dev)
        y_full[train.long()] = y
        gp = part("fleet distributed", ("ell_spmv", "ell_spmv_t", "walk_sampler_vals"),
                  sharded_gp, absent=("khat_fused",))
        for label in ("sharded_cg_solve", "sharded_cg_solve_chunked"):
            x, iters, conv, wall = gp[label]
            _, rel = rel_err(x, ref.x)
            expect(bool(conv) and rel <= DIST["rtol"],
                   f"{label}: converged {bool(conv)}, rel {rel:.2e} to the single-device solve")
            print(f"[fleet] {label} at N = {MAIN['n_nodes']} (K = {wcfg.slots}, world "
                  f"size 1, {backend}): {iters} iterations in {wall * 1e3:.1f} ms, rel "
                  f"{rel:.2e} of the single-device solve ({ref.iters} iterations, "
                  f"{ref_s * 1e3:.1f} ms on the fused K̂ kernel)")
        s, iters, conv, wall = gp["sharded_posterior_sample"]
        expect(tuple(s.shape) == (MAIN["n_nodes"],) and bool(torch.isfinite(s).all()),
               f"sharded posterior sample {tuple(s.shape)} not finite")
        print(f"[fleet] sharded_posterior_sample over {len(train)} observed rows: shape "
              f"{tuple(s.shape)}, finite, {iters} iterations (converged {bool(conv)}) "
              f"in {wall * 1e3:.1f} ms")
    finally:
        dist.destroy_process_group()
        store.cleanup()
    print(f"[fleet] through the distributed GP in {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # 4. The fleet killed at its 4th observe in a child process, recovered here.
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_kill_")
    try:
        jpath = os.path.join(tmp.name, "fleet.jsonl")
        child = _FLEET_CHILD.format(src=str(SRC), root=str(ROOT), fleet=FLEET,
                                    device=str(dev), jpath=jpath)
        env = dict(os.environ, REPRO_FAULTS=f"kill_at:{c['kill_at']}")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", child], env=env,
                              capture_output=True, text=True, timeout=300)
        child_s = time.perf_counter() - t0
        expect(proc.returncode == KILL_EXIT_CODE
               and "hit at 'serving.fleet.observe'" in proc.stderr,
               f"fleet child exited {proc.returncode}: {proc.stderr[-2000:]}")
        events = read_journal(jpath)
        kinds = [e["type"] for e in events]
        expect(kinds == ["observe"] * 3 + ["forget", "observe"],
               f"fleet journal after the kill: {kinds}")

        def recovery():
            t0 = time.perf_counter()
            st, n_ev = recover(empty, jpath, None)
            sync(dev)
            rec_s = time.perf_counter() - t0
            fold = empty
            for ev in events:
                fold = (serving.observe_batch(fold, ev["nodes"], ev["ys"])
                        if ev["type"] == "observe" else serving.forget(fold, ev["slot"]))
            return st, n_ev, rec_s, fold

        st, n_ev, rec_s, fold = part("fleet recover", ("walk_sampler", "gram_block"),
                                     recovery)
        q = torch.from_numpy(np.random.default_rng(c["seed"] + 3).choice(
            c["n_nodes"], c["n_moments"], replace=False).astype(np.int32)).to(dev)
        expect(n_ev == len(events) and int(st.count) == 7 and all(
            torch.equal(a, b) for a, b in zip(serving.posterior_moments(st, q),
                                              serving.posterior_moments(fold, q))),
            "recovered fleet state differs from the journalled fold")
        print(f"[fleet] kill_at:{c['kill_at']}: child exit {proc.returncode} in "
              f"{child_s:.1f} s ('serving.fleet.observe'), journal {kinds} (the killed "
              f"observe written ahead of its dispatch); recover of {n_ev} events "
              f"{rec_s * 1e3:.1f} ms, bit-equal to the journalled fold on "
              f"{c['n_moments']} nodes")
    finally:
        tmp.cleanup()
    return dict(counts=total, stats=stats, ratio=ratio, busy=busy, gp=gp,
                child_s=child_s, recover_ms=rec_s * 1e3)


def _tensors(packed):
    """The tensors of a packed ServeState, the trace's three in order."""
    for x in packed:
        yield from ((x,) if hasattr(x, "dtype") else (x.cols, x.loads, x.lens))


class _Preempted(Exception):
    pass


def bo_resume(dev, directory: str, part) -> dict:
    """thompson_sampling_incremental at N = 10⁶ checkpointed every round
    through CheckpointManager (non-blocking, as the driver twin does),
    stopped after ``RESIL["bo_rounds"]`` rounds, then resumed from the
    manager's latest step to the full run; the BO tree's blocking save and
    restore bit-equal."""
    import torch

    from repro_torch.bo import thompson
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import modulation, walks
    from repro_torch.graphs import generators, signals

    n = SERVE["n_nodes"]
    graph = generators.ring(n, k=SERVE["ring_k"], device=dev)
    wcfg = walks.WalkConfig(SERVE["n_walkers"], SERVE["p_halt"], SERVE["l_max"])
    mod = modulation.diffusion(l_max=SERVE["l_max"])
    truth = signals.smooth_periodic_ring(n, seed=1)
    kw = dict(n_init=BO["n_init"], n_steps=BO["rounds"], refit_every=BO["refit_every"],
              refit_steps=BO["refit_steps"], noise_std=0.1, f_max=float(truth.max()),
              n_candidates=BO["n_candidates"])
    mgr = CheckpointManager(directory, keep=2)

    def tree(st):
        return {"x_buf": st.x_buf, "y_buf": st.y_buf, "params": st.params}

    def cb(st):
        mgr.save(st.iteration, tree(st), blocking=False,
                 extra={"count": st.count, "iteration": st.iteration,
                        "regret": st.regret})
        if st.iteration == RESIL["bo_rounds"]:
            raise _Preempted

    def objective(idx):
        return truth[np.asarray(idx)]

    def first():
        t0 = time.perf_counter()
        try:
            thompson.thompson_sampling_incremental(graph, wcfg, mod, objective, 17,
                                                   checkpoint_cb=cb, **kw)
        except _Preempted:
            pass
        mgr.wait()
        return time.perf_counter() - t0

    need = ("walk_sampler", "gram_block", "khat_fused", "ell_spmv_t")
    first_s = part("resilience bo", need, first)
    cap = BO["n_init"] + BO["rounds"]
    example = {"x_buf": np.zeros(cap, np.int32), "y_buf": np.zeros(cap, np.float32),
               "params": thompson.mll.init_hyperparams(mod, device=dev)}
    t0 = time.perf_counter()
    saved, manifest = mgr.restore(example)
    restore_ms = (time.perf_counter() - t0) * 1e3
    extra = manifest["extra"]
    expect(mgr.latest_step() == RESIL["bo_rounds"] == extra["iteration"],
           f"BO checkpoint at step {mgr.latest_step()}")
    state = thompson.BOState(x_buf=saved["x_buf"], y_buf=saved["y_buf"],
                             count=extra["count"], params=saved["params"],
                             regret=list(extra["regret"]), iteration=extra["iteration"])

    def resume():
        t0 = time.perf_counter()
        st = thompson.thompson_sampling_incremental(graph, wcfg, mod, objective, 17,
                                                    state=state, **kw)
        return st, time.perf_counter() - t0

    st, resume_s = part("resilience bo resume", need, resume)
    expect(st.iteration == BO["rounds"] and len(st.regret) == BO["rounds"]
           and np.isfinite(st.regret).all()
           and len(np.unique(st.x_obs)) == st.count == cap,
           f"resumed BO: iteration {st.iteration}, regret {st.regret}")
    t0 = time.perf_counter()
    mgr.save(BO["rounds"], tree(st), extra={"count": st.count})
    save_ms = (time.perf_counter() - t0) * 1e3
    back, _ = mgr.restore(example)
    same = (np.array_equal(back["x_buf"], st.x_buf)
            and np.array_equal(back["y_buf"], st.y_buf)
            and torch.equal(back["params"]["log_sigma_n"], st.params["log_sigma_n"])
            and all(torch.equal(back["params"]["mod"][k], v)
                    for k, v in st.params["mod"].items()))
    expect(same, "BO state restore not bit-equal")
    print(f"[resilience] BO: {RESIL['bo_rounds']} rounds at N = {n} in "
          f"{first_s * 1e3:.1f} ms, checkpoint restored in {restore_ms:.1f} ms, "
          f"resumed to round {st.iteration} in {resume_s * 1e3:.1f} ms; regret "
          + ", ".join(f"{r:.4f}" for r in st.regret)
          + f"; BO tree save {save_ms:.1f} ms, restore bit-equal")
    return dict(regret=st.regret, first_s=first_s, resume_s=resume_s)


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
    profiled calls of ``fn``, in order of first appearance.  A short window
    can come back from the profiler empty (ten coalesced K̂ products at the
    posterior's CG shape did), so an empty one is profiled again over ten
    times the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for calls in (reps, 10 * reps):
        sync(dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                sync(dev)
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            return list(dict.fromkeys(names))
    expect(False, "the profiler saw no device activity")


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


def flash_digests(dev, call) -> list:
    """sha-256 prefixes of ``call(q, k, v, kw)`` at PRE_OFFSET_CASES, f32 then
    bf16, from numpy inputs (the same bytes on any machine)."""
    import hashlib

    import torch

    out = []
    for i, ((b, h, hkv, sq, skv, d), kw) in enumerate(PRE_OFFSET_CASES):
        rng = np.random.default_rng(500 + i)
        base = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                for s in ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]
        for dt, raw in ((torch.float32, torch.int32), (torch.bfloat16, torch.int16)):
            q, k, v = (t.to(dev).to(dt) for t in base)
            o = call(q, k, v, kw).contiguous()
            sync(dev)
            out.append(hashlib.sha256(o.view(raw).cpu().numpy().tobytes())
                       .hexdigest()[:16])
    return out


# The offset shards' timing rows, which join flash_attention's row.
OFFSET_ROWS: list = []


def check_offset_cases(dev) -> None:
    """(a) of phase sharding: OFFSET_CASES against mha_ref(q_offset=...),
    each gated on the instance the rule names; the last shard of each case
    timed (graph replays) beside the plain version and SDPA with its
    boolean mask; then q_offset = 0 against the earlier kernel's digests."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for i, ((b, h, hkv, s, d), kw, parts, shards) in enumerate(OFFSET_CASES):
        sl = s // parts
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = attn_inputs(dev, (b, h, hkv, s, s, d), dt, 600 + i)
            for r in shards:
                qr = q[:, :, r * sl:(r + 1) * sl]
                before = dict(ops.LAUNCHES)
                got = ops.flash_attention(qr, k, v, q_offset=r * sl, **kw)
                sync(dev)
                inst = (ops.TENSOR_CORE if tc_expected(dt, d) and ops.aligned(qr, k, v)
                        else ops.CUDA_CORE)
                expect(ops.LAUNCHES[inst] == before[inst] + 1,
                       f"flash_attention offset {r * sl}: expected a {inst} launch")
                want = ref.mha_ref(qr, k, v, q_offset=r * sl, **kw)
                if dt == torch.float32:
                    err, rel = rel_err(got, want)
                    expect(rel <= ATTN_RTOL, f"flash_attention [{b},{h},{sl}/{s},{d}] "
                           f"{kw} offset {r * sl} f32: rel {rel:.2e}")
                else:
                    err, rel = bf16_err(got, want)
                    expect(rel <= BF16_ULPS, f"flash_attention [{b},{h},{sl}/{s},{d}] "
                           f"{kw} offset {r * sl} bf16: {rel:.2f} ulps")
                worst[dt] = max(worst[dt], rel)
                n += 1
                del want
            if dt == torch.bfloat16:   # time the last shard (the most keys)
                r = shards[-1]
                qr = q[:, :, r * sl:(r + 1) * sl]
                call = lambda: ops.flash_attention(qr, k, v, q_offset=r * sl, **kw)  # noqa: E731
                ms = graph_ms(call, 5)
                pms = cuda_ms(lambda: ref.mha_ref(qr, k, v, q_offset=r * sl, **kw), 2,
                              warmup=1)
                qpos = r * sl + torch.arange(sl, device=dev)[:, None]
                kpos = torch.arange(s, device=dev)[None, :]
                mask = kpos <= qpos
                if kw.get("window"):
                    mask &= kpos > qpos - kw["window"]
                lib = graph_ms(lambda: F.scaled_dot_product_attention(
                    qr, k, v, attn_mask=mask, enable_gqa=True), 5)
                pairs = int(mask.sum())
                nbytes = b * (2 * h * sl * d + 2 * hkv * s * d) * 2
                flops = b * 4 * d * h * pairs
                bd = bound(nbytes, flops, BF16_TC_FLOP_PER_S)
                err = bf16_err(call(), ref.mha_ref(qr, k, v, q_offset=r * sl, **kw))[0]
                print(f"[timing] flash_attention offset shard [{b},{h},{sl},{d}] at "
                      f"q_offset {r * sl} over [{b},{hkv},{s},{d}] bf16 {kw or 'causal'} "
                      f"({pairs} open pairs, {flops / 1e9:.1f} GFLOP): kernel {ms:.4f} ms "
                      f"(graph replays), plain {pms:.4f} ms, library (SDPA, boolean "
                      f"mask) {lib:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]})")
                OFFSET_ROWS.append(dict(shape=[b, h, hkv, sl, s, d], q_offset=r * sl,
                                        path="sharding", ms=ms, plain_ms=pms,
                                        library_ms=lib, bound_ms=bd[0],
                                        bound_by=bd[1], max_abs_err=err))
                del mask
            del q, k, v
            torch.cuda.empty_cache()
    print(f"[sharding] flash_attention with q_offset matches mha_ref(q_offset) at "
          f"{n} query shards (gemma3-4b's and whisper-base's prefill_32k over 16 "
          f"model ranks, window 1024 among them): f32 rel {worst[torch.float32]:.2e} "
          f"(limit {ATTN_RTOL:g}), bf16 {worst[torch.bfloat16]:.2f} ulps (limit "
          f"{BF16_ULPS})")
    got = flash_digests(dev, lambda q, k, v, kw: ops.flash_attention(q, k, v, q_offset=0, **kw))
    print(f"[sharding] flash_attention at q_offset 0, output digests {got}")
    expect(got == PRE_OFFSET_DIGESTS, f"flash_attention at q_offset 0 differs from the "
           f"earlier kernel: {got} against {PRE_OFFSET_DIGESTS}")
    print(f"[sharding] ... bit for bit those of the earlier kernel at {len(PRE_OFFSET_CASES)} "
          f"cases, f32 and bf16 (both instances)")


def sharded_train(dev) -> dict:
    """(b) of phase sharding: the plain step, then the DTensor step of the
    same state and batch under a one-rank process group (NCCL on the card,
    gloo when rehearsed on the CPU); launches gated as in phase train."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import configs
    from repro_torch.data import TokenStream
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import sharding as shr
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import AdamState

    c = TRAIN
    cfg = dataclasses.replace(configs.get_config(c["arch"]), fsdp=True, zero1=True,
                              sp_attn=True)
    opt = AdamW(lr=c["lr"], weight_decay=c["weight_decay"], grad_clip=c["clip"])
    batch = TokenStream(cfg.vocab_size, c["batch"], c["seq"], seed=c["seed"]).next_batch()
    state = train.init_state(cfg, c["seed"], opt, dev)
    state, m = train.make_train_step(cfg, opt)(state, train.batch_to(batch, dev))
    want_loss, want = m["loss"], state.params
    del state, m
    torch.cuda.empty_cache()

    store = tempfile.TemporaryDirectory(prefix="chip_smoke_sharding_")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store.name}/pg", world_size=1, rank=0)
    try:
        mesh = tmesh.make_host_mesh(1, 1, device_type=dev.type)
        plain = train.init_state(cfg, c["seed"], opt, dev)
        params = shr.distribute(plain.params, mesh,
                                shr.param_shardings(plain.params, mesh, cfg))
        o = shr.opt_shardings(plain.params, mesh, cfg)
        mu = shr.distribute(plain.opt_state.mu, mesh, o)
        nu = shr.distribute(plain.opt_state.nu, mesh, o)
        del plain
        bp = shr.placements(shr.batch_spec(mesh, c["batch"], 2), mesh)
        dbatch = {k: distribute_tensor(v, mesh, bp)
                  for k, v in train.batch_to(batch, dev).items()}
        step = train.make_train_step(cfg, opt)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        shr.set_activation_mesh(mesh)
        try:
            reset_counts()
            sync(dev)
            t0 = time.perf_counter()
            new, m = step(train.TrainState(params, AdamState(0, mu, nu), 0), dbatch)
            sync(dev)
            first_s = time.perf_counter() - t0
            counts = counts_now()
            loss = m["loss"].full_tensor()
            got = shr.to_full(new.params)
            worst = rel_err(loss, want_loss)[1]
            equal = bool(torch.equal(loss, want_loss))
            for a, b in zip(model.tree_leaves(got), model.tree_leaves(want)):
                worst = max(worst, rel_err(a, b)[1])
                equal = equal and bool(torch.equal(a, b))
            del got
            sync(dev)
            t0 = time.perf_counter()
            step(new, dbatch)
            sync(dev)
            second_s = time.perf_counter() - t0
        finally:
            shr.set_activation_mesh(None)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    finally:
        dist.destroy_process_group()
        store.cleanup()
    want_flash, want_norm = lm_launches(cfg, "train")
    tc = flash_ops.TENSOR_CORE
    gate_counts("sharding", counts, ("flash_attention", tc, "rmsnorm"))
    expect(counts["flash_attention"] == want_flash and counts[tc] == want_flash
           and counts["rmsnorm"] == want_norm,
           f"sharded train step launched {counts}; expected {want_flash} flash (all "
           f"tensor-core) and {want_norm} rmsnorm")
    expect(worst <= SHARD["rtol"], f"sharded train step vs plain: rel {worst:.2e}")
    print(f"[sharding] {cfg.name} at full width and depth, fsdp + ZeRO-1 + sp_attn, "
          f"params/μ/ν as DTensors on a 1×1 {'NCCL' if dev.type == 'cuda' else 'gloo'} "
          f"mesh: loss {float(loss):.6f} (plain {float(want_loss):.6f}); loss and params "
          f"{'bit-equal' if equal else f'within {worst:.2e} of scale'} of the plain "
          f"step (limit {SHARD['rtol']:g}); launches flash {counts['flash_attention']} "
          f"(tensor-core {counts[tc]}), rmsnorm {counts['rmsnorm']}; step ms first "
          f"{first_s * 1e3:.1f}, second {second_s * 1e3:.1f}; max_memory_allocated "
          f"{mib(peak)} MiB")
    return dict(counts=counts, first_s=first_s, second_s=second_s, peak=peak,
                worst=worst, equal=equal)


def sharded_dryrun() -> dict:
    """(c) of phase sharding: SHARD's arch at its four shapes and the GRF-GP
    cell, plain and compact, on both production meshes, records under
    chiprun_out/dryrun/."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.models.config import SHAPES

    out = {}
    t0 = time.perf_counter()
    try:
        for mesh_name, multi in dryrun.MESHES.items():
            mesh = dryrun.production_mesh(multi)
            out_dir = str(ROOT / "chiprun_out" / "dryrun" / mesh_name)
            recs = [dryrun.run_cell(SHARD["dry_arch"], shape, mesh, mesh_name, out_dir)
                    for shape in SHAPES]
            recs += [dryrun.run_gp_cell(mesh, mesh_name, out_dir, compact=compact)
                     for compact in (False, True)]
            for rec in recs:
                label = (f"{rec['arch']}/{rec['shape']}"
                         + (" compact" if rec.get("compact") else ""))
                print(f"[sharding] dry run [{mesh_name}] {label}: {dryrun.describe(rec)}")
                expect(rec["status"] == "ok", f"dry run {mesh_name} {label}: {rec.get('error')}")
                expect(rec["roofline"]["flops_per_device"] > 0,
                       f"dry run {mesh_name} {label}: no FLOPs")
                out[(mesh_name, label)] = rec["roofline"]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[sharding] dry run of {len(out)} records in {time.perf_counter() - t0:.1f} s")
    return out


def phase_sharding(dev) -> dict:
    """(a) the q_offset kernel, (b) the DTensor train step, (c) the dry run."""
    check_offset_cases(dev)
    res = sharded_train(dev)
    res["dryrun"] = sharded_dryrun()
    return res


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
    # serving, the two BO loops, solvers, lm, train, lm-archs, baselines,
    # svgp, jlt, obs, the parts of resilience and fleet, and the sharded
    # train step), each counted from 0.
    path_counts = [main["counts"], results["fit"]["counts"],
                   results["serving"]["counts"],
                   *(results["bo"][e]["counts"] for e in ("incremental",
                                                          "refit-chunked")),
                   results["solvers"]["counts"], results["lm"]["counts"],
                   results["train"]["counts"], results["lm-archs"]["counts"],
                   *(results[p]["counts"] for p in ("baselines", "svgp", "jlt",
                                                     "obs", "resilience", "fleet",
                                                     "sharding"))]
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
    rows.append(timing_walks(dev, graph, seed,
                             counts["walk_sampler"] + counts["walk_sampler_vals"],
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
    h.matvec(alpha)   # builds the coalesced payload, once per (trace, f)
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
    per_step = results["train"]["per_step"]
    rows.append(timing_flash(dev, counts["flash_attention"], per_step["flash_attention"]))
    rows.append(timing_rmsnorm(dev, counts["rmsnorm"], per_step["rmsnorm"]))
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
               reps: int, vals: bool = False) -> dict:
    """walk_sampler over the first ``m`` nodes of ``graph``: bit-equal to
    the plain version for every scheme, device time as graph replays (few:
    a replayed graph keeps every call's outputs) and an eager loop, the
    plain version's time, and the bound: the outputs written once and the
    adjacency row and degree of each node the walks visit (counted from
    this run's cols).  With ``vals``, the vals entry (the chunked products'
    walks: cols and vals, 8 B a slot, in place of cols, loads and lens, 12
    B) against walk_sample_vals_ref, timed beside the composition it
    replaces (walk_sample, then (loads·valid)·f[lens])."""
    import torch

    from repro_torch.core import modulation
    from repro_torch.kernels.walk_sampler import ops, ref, rng

    d = graph.max_deg
    nodes = torch.arange(m, dtype=torch.int32, device=dev)
    kw = dict(n_walkers=cfg["n_walkers"], p_halt=cfg["p_halt"], l_max=cfg["l_max"])
    args = (graph.neighbors, graph.weights, graph.deg, nodes, seed)
    entry, plain, extra = ops.walk_sample, ref.walk_sample_ref, {}
    if vals:
        mod = modulation.diffusion(l_max=cfg["l_max"])
        f = mod(mod.init(device=dev)).detach()
        args = (graph.neighbors, graph.weights, graph.deg, nodes, f, m, seed)
        entry, plain = ops.walk_sample_vals, ref.walk_sample_vals_ref
    for scheme in rng.SCHEMES:
        got = entry(*args, **kw, scheme=scheme)
        want = plain(*args, **kw, scheme=scheme)
        expect(all(torch.equal(a, b) for a, b in zip(got, want)),
               f"walk_sampler {label}{', vals' * vals}: {scheme} differs from "
               f"the plain version")
        if scheme == "iid":
            seen = torch.zeros(graph.n_nodes, dtype=torch.bool, device=dev)
            seen[got[0].reshape(-1).long()] = True
            visited = int(seen.sum())
            del seen
        del got, want
    k = cfg["n_walkers"] * (cfg["l_max"] + 1)
    fn = lambda: entry(*args, **kw)   # noqa: E731
    ms, eager = graph_ms(fn, reps), cuda_ms(fn, max(reps, 5))
    pms = cuda_ms(lambda: plain(*args, **kw), 2, warmup=1)
    outs = 2 if vals else 3
    b = bound(outs * m * k * 4 + m * 4 + visited * (d * 8 + 4),
              m * k * (7 if vals else 6))
    note = ""
    if vals:
        wargs = (graph.neighbors, graph.weights, graph.deg, nodes, seed)
        valid = torch.ones(m, dtype=torch.float32, device=dev)

        def composed():
            _, loads, lens = ops.walk_sample(*wargs, **kw)
            return (loads * valid[:, None]).to(f.dtype) * f[lens]

        extra = dict(entry="walk_sample_vals_launch",
                     composed_ms=cuda_ms(composed, max(reps, 5)))
        note = (f", walk_sample + the vals build {extra['composed_ms']:.4f} ms "
                f"(eager)")
    print(f"[timing] walk_sampler {label}{', vals entry' * vals} [{m}, {k}] "
          f"({cfg['n_walkers']} walkers, l_max {cfg['l_max']}): kernel {ms:.4f} "
          f"ms (graph; eager loop {eager:.4f} ms), plain {pms:.4f} ms{note}, "
          f"bound {b[0]:.4f} ms ({b[1]}; {visited} nodes visited), bit-equal "
          f"for {len(rng.SCHEMES)} schemes")
    torch.cuda.empty_cache()
    return dict(shape=[m, k], ms=ms, eager_ms=eager, plain_ms=pms,
                bound_ms=b[0], bound_by=b[1], visited=visited, max_abs_err=0.0,
                **extra)


def timing_walks(dev, graph, seed: int, launches: int, extra=()) -> dict:
    """walk_sampler at WALK_SHAPES (see :func:`walk_shape`), then the
    shapes ``extra`` that other phases measured."""
    shapes = []
    for label, cfg, m in WALK_SHAPES:
        k = cfg["n_walkers"] * (cfg["l_max"] + 1)
        reps = 40 if m < graph.n_nodes else (5 if k <= 48 else 3)
        shapes.append(walk_shape(dev, graph, seed, label, cfg, m, reps))
        if label == "chunk":
            shapes.append(walk_shape(dev, graph, seed, label, cfg, m, reps,
                                     vals=True))
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
    solv["h"].matvec(p)   # builds the coalesced payload, once per (trace, f)
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


def timing_flash(dev, launches: int, per_step: int) -> dict:
    """flash_attention at the LM path's shapes (danube, bf16, causal,
    window 4096): the prefills at batch 1 and the train step's 2 x 2048
    (``per_step`` launches a step): each instance apart (device time of
    graph replays), the wrapper's eager loop, mha_ref, SDPA with a boolean
    mask and, where the window is wider than the prompt (the same function),
    SDPA with is_causal."""
    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops, ref

    cfg = configs.get_config(LM["arch"])
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    w = cfg.stages[0][1][0].window
    shapes = []
    cases = [(1, n, "prefill") for n in sorted({n for _, n in LM["waves"]})]
    cases.append((TRAIN["batch"], TRAIN["seq"], "train"))
    for i, (bsz, s, kind) in enumerate(cases):
        q, k, v = attn_inputs(dev, (bsz, h, hkv, s, s, d), torch.bfloat16, 300 + i)
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
        nbytes = bsz * (2 * h * s * d + 2 * hkv * s * d) * 2
        flops = bsz * 4 * d * h * pairs
        b_tc = bound(nbytes, flops, BF16_TC_FLOP_PER_S)
        b_f32 = bound(nbytes, flops)
        causal_txt = ("n/a (the window is narrower than the prompt)"
                      if lib_causal is None else f"{lib_causal:.4f} ms")
        print(f"[timing] flash_attention ({kind}) [{bsz},{h},{s},{d}] / "
              f"[{bsz},{hkv},{s},{d}] bf16, "
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
        if kind == "train":
            print(f"[timing] flash_attention (train) launches {per_step} times a "
                  f"train step (24 forward, 24 recomputed under remat): "
                  f"{per_step * ms:.3f} ms a step at the graph-replay time")
        shapes.append(dict(shape=[bsz, h, hkv, s, d], path=kind, ms=ms,
                           per_step=per_step if kind == "train" else None,
                           cuda_core_ms=cc_ms,
                           eager_ms=eager_ms, plain_ms=pms, library_ms=lib,
                           library_causal_ms=lib_causal, bound_ms=b_tc[0],
                           bound_by=b_tc[1], bound_f32_ms=b_f32[0],
                           max_abs_err=errs[0]))
        del q, k, v, mask
        torch.cuda.empty_cache()
    head = shapes[1]    # the 4608-token prefill, past the window
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces=REPLACES["flash_attention"], launches=launches,
                max_abs_err=max(x["max_abs_err"] for x in shapes),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"], shapes=shapes + OFFSET_ROWS)


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


def timing_rmsnorm(dev, launches: int, per_step: int) -> dict:
    """rmsnorm at the LM path's rows (bf16 x, f32 scale; the train step's
    [4096, 2560] last, ``per_step`` launches a step), against rmsnorm_ref
    and torch.nn.functional.rms_norm with weight 1 + scale: device time of
    graph replays, the eager loop, and host time per call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops, ref

    gen = torch.Generator(device=dev).manual_seed(31)
    shapes = []
    for m, d in NORM_SHAPES + [TRAIN_NORM]:
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
        if (m, d) == TRAIN_NORM:
            print(f"[timing] rmsnorm (train) launches {per_step} times a train "
                  f"step: {per_step * ms:.3f} ms a step at the graph-replay time")
        shapes.append(dict(shape=[m, d], ms=ms, eager_ms=eager_ms, plain_ms=pms,
                           path="train" if (m, d) == TRAIN_NORM else "serve",
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
        ("train", lambda: phase_train(dev)),
        ("lm-archs", lambda: phase_lm_archs(dev)),
        ("parity-baselines", lambda: check_baseline_kernels(dev)),
        ("baselines", lambda: phase_baselines(dev)),
        ("svgp", lambda: phase_svgp(dev)),
        ("jlt", lambda: phase_jlt(dev)),
        ("obs", lambda: phase_obs(dev)),
        ("resilience", lambda: phase_resilience(dev)),
        ("fleet", lambda: phase_fleet(dev)),
        ("sharding", lambda: phase_sharding(dev)),
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
