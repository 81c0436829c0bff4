"""Solver strategy layer quickstart on the PyTorch port — also a smoke gate.

    PYTHONPATH=src python -m repro_torch.examples.solver_strategies --nodes 5000
    PYTHONPATH=src python -m repro_torch.examples.solver_strategies --nodes 2000 --device cpu

The twin of examples/solver_strategies.py, with the same flags, checks and
result line.  One clustered GP training block, solved under every
preconditioner (including ``"auto"``, whose spectrally-probed rank choice is
printed), a mixed-precision (bf16-payload) solve and a warm start, plus an
SLQ-based exact LML — every path through ``repro_torch.solvers.solve`` /
``SolveStrategy``.  Exits non-zero if any solve fails to converge or the
solutions disagree.  It runs on the CUDA card (``--device cpu`` runs the
plain PyTorch versions instead).
"""
from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import solvers
from repro_torch.core import linops, modulation, walks
from repro_torch.gp import mll
from repro_torch.graphs import generators


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--train", type=int, default=256)
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    g = generators.ring(args.nodes, k=3, device=dev)
    cfg = walks.WalkConfig(n_walkers=8, p_halt=0.15, l_max=5)
    mod = modulation.diffusion(l_max=cfg.l_max)
    f = mod({"log_beta": torch.tensor(math.log(3.0), device=dev),
             "log_sigma_f": torch.tensor(0.0, device=dev)})
    train = torch.arange(args.train, dtype=torch.int32, device=dev)
    seed = walks.walk_seed(torch.Generator().manual_seed(0))
    trace_x = walks.sample_walks_for_nodes(        # contiguous ⇒ correlated rows
        g, train, seed, cfg.n_walkers, cfg.p_halt, cfg.l_max, cfg.reweight)
    h = linops.shifted(trace_x, f, 1e-2, args.nodes)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        args.train).astype(np.float32)).to(dev)

    sols, ok = {}, True
    for pc in solvers.PRECONDITIONERS:
        st = solvers.SolveStrategy(tol=1e-6, max_iters=2000, preconditioner=pc,
                                   precond_rank=args.rank)
        res = solvers.solve(h, y, st)
        conv = bool(torch.all(res.converged))
        ok &= conv
        sols[pc] = res.x.cpu().numpy()
        print(f"{pc:>8}: iters={res.iters:4d} converged={conv}"
              + (f" rank={res.precond_rank}" if pc == "auto" else ""))

    # Mixed precision: bf16 payload matvecs, f32 recurrence — must reach the
    # same fixed point (loose tolerance below).
    bf16 = solvers.solve(h, y, solvers.SolveStrategy(
        tol=1e-6, max_iters=2000, preconditioner="jacobi",
        precond_rank=args.rank, matvec_dtype="bfloat16"))
    conv = bool(torch.all(bf16.converged))
    ok &= conv
    sols["bf16"] = bf16.x.cpu().numpy()
    print(f"{'bf16':>8}: iters={bf16.iters:4d} converged={conv}")

    warm = solvers.solve(
        h, y, solvers.SolveStrategy(tol=1e-6, max_iters=2000, warm_start=True),
        x0=torch.from_numpy(sols["jacobi"]).to(dev))
    print(f"{'warm':>8}: iters={warm.iters:4d} "
          f"converged={bool(torch.all(warm.converged))}")
    ok &= bool(torch.all(warm.converged)) and warm.iters <= 3

    for pc, x in sols.items():
        if pc == "bf16":
            # bf16 payloads perturb the *operator*, so the check is
            # norm-relative.
            rel = np.linalg.norm(x - sols["none"]) / np.linalg.norm(sols["none"])
            if rel > 5e-2:
                print(f"MISMATCH: bf16 rel err {rel:.3f} vs unpreconditioned")
                ok = False
        elif not np.allclose(sols["none"], x, rtol=5e-3, atol=5e-3):
            print(f"MISMATCH: {pc} disagrees with unpreconditioned solve")
            ok = False

    out = mll.exact_lml(trace_x, f, 1e-2, y, args.nodes,
                        torch.Generator().manual_seed(1), n_probes=16,
                        slq_iters=48)
    print(f"exact LML = {float(out['lml']):.2f} "
          f"(datafit {float(out['datafit']):.2f}, "
          f"logdet {float(out['logdet']):.2f}, "
          f"converged={out['converged']})")
    ok &= out["converged"] and math.isfinite(float(out["lml"]))

    print("SOLVER_SMOKE_OK" if ok else "SOLVER_SMOKE_FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
