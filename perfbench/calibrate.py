"""Readings of a cell's compared numbers over many seeds, in one process,
and the hyperparameter fit that a configuration's ``hyperparams`` state.

    python3 perfbench/calibrate.py --workload ring-1m.sample --seeds 1,2,3 [--control]
    python3 perfbench/calibrate.py --workload sphere-1m.track --seeds 0 --fit 80

Each seed sets the cell up as a run does, serves ``check_outputs``
requests through the timed entry, drops the program's state and runs the
check; one JSON line per seed.  ``--control`` switches on the program's own
lower-precision path (bfloat16 matvec payloads), which the limits must
fail.  ``--fit STEPS`` instead fits the cell's hyperparameters with the
float64 reference alone (the LML surrogate with Adam, from the program's
initial values), on the cell's observations with the seed's noise, and
prints each step.  The limits of ``traffic/*.json`` and the fitted
``hyperparams`` of ``configs/*.json`` were set from these readings;
benchmark runs never run this.
"""
import argparse
import gc
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, control: bool, device) -> dict:
    """The compared numbers of one seed (or of the control on it)."""
    import torch

    t0 = time.perf_counter()
    session = cell.driver.setup(cell.config, cell.traffic, seed, device,
                                control=control)
    kept = [session.request(i)
            for i in range(int(cell.traffic.get("check_outputs", 1)))]
    session.release()
    gc.collect()
    torch.cuda.empty_cache()
    checks, _ = session.check(kept)
    del kept, session
    gc.collect()
    torch.cuda.empty_cache()
    return {"seed": seed, "control": control, "checks": checks,
            "s": time.perf_counter() - t0}


FIT = {"lr": 0.08, "probes": 8, "tol": 1e-5, "max_iters": 20000,
       "init": {"beta": 1.0, "sigma_f": 1.0, "sigma_n2": 0.01}}


def fit(cell, seed: int, steps: int, device):
    """Adam on the reference's LML surrogate; yields one dict a step."""
    import numpy as np
    import torch

    from perfbench.drivers import common
    from perfbench.reference import gp, walks as ref_walks

    cfg, w = cell.config, cell.config["walks"]
    rng = np.random.default_rng(seed)
    nb, wt, deg, _ = common.host_graph(cfg)
    n = len(deg)
    walk_seed = int(rng.integers(0, 2**32))
    train, y = common.observations(cfg, cell.traffic, rng, n)
    t = lambda a: torch.from_numpy(a).to(device)                 # noqa: E731
    cols, loads, lens = ref_walks.sample(t(nb), t(wt), t(deg), t(train),
                                         walk_seed, w["n_walkers"],
                                         w["p_halt"], w["l_max"])
    y = t(y).to(gp.F64)
    theta = common.theta({"hyperparams": FIT["init"]}, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = {}
    for step in range(steps):
        t0 = time.perf_counter()
        bits = torch.randint(0, 2, (len(train), FIT["probes"]), generator=gen,
                             device=device)
        z = bits.to(gp.F64) * 2.0 - 1.0
        loss, datafit, grads, it = gp.surrogate_step(
            cols, loads, lens, n, theta, y, z, w["l_max"], FIT["tol"],
            FIT["max_iters"])
        theta = gp.adam_update(theta, grads, state, FIT["lr"])
        yield {"step": step + 1, "loss": loss, "datafit": datafit,
               "cg_iters": it, "s": time.perf_counter() - t0,
               "hyperparams": {"beta": math.exp(float(theta["log_beta"])),
                               "sigma_f": math.exp(float(theta["log_sigma_f"])),
                               "sigma_n2": math.exp(2 * float(theta["log_sigma_n"]))}}


def main(argv=None) -> int:
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "perfbench" / "triton")
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench.harness import spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fit", type=int, default=0, metavar="STEPS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    build.BUILD_DIR = ROOT / "build" / "repro_torch"
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.fit:
            for rec in fit(cell, seed, args.fit, device):
                print(json.dumps(rec), flush=True)
            continue
        print(json.dumps(readings(cell, seed, args.control, device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
