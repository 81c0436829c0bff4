"""End-to-end driver (the paper's flagship application, §4.3): find the most
influential user in a social network by Thompson-sampling BO with GRF-GPs,
on the PyTorch port.

    PYTHONPATH=src python -m repro_torch.examples.bo_social_network --nodes 20000
    PYTHONPATH=src python -m repro_torch.examples.bo_social_network --nodes 1000000

The twin of examples/bo_social_network.py, with the same flags and defaults
except those listed under "left out" in --help.  It runs on the CUDA card
(``--device cpu`` runs the plain PyTorch versions instead).  The default
engine is the *incremental* serving loop: one ServeState reused across the
run, O(m²) Cholesky appends per observation, joint Thompson draws over a
candidate set.  ``--engine refit`` runs the paper's from-scratch loop
(materialised trace + pathwise sample per round).  ``--record PATH``
streams a JSONL flight record of the run and prints the obs summary.
"""
import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import obs
from repro_torch.bo import baselines, thompson
from repro_torch.core import modulation, walks
from repro_torch.graphs import generators

LEFT_OUT = ("left out of the port so far: --ckpt (checkpoint resume; the "
            "loop's state= resume argument is ported)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 epilog=LEFT_OUT)
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--init", type=int, default=200)
    ap.add_argument("--walkers", type=int, default=20)
    ap.add_argument("--engine", choices=["incremental", "refit"],
                    default="incremental")
    ap.add_argument("--candidates", type=int, default=2048,
                    help="Thompson candidate set per round (incremental)")
    ap.add_argument("--record", metavar="PATH", default=None,
                    help="stream a JSONL flight record of the run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    recording = (obs.recording(args.record) if args.record is not None
                 else contextlib.nullcontext())
    with recording:
        run(args)
    if args.record is not None:
        print(f"\nflight record written to {args.record}")
        print(obs.summary())


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args):
    dev = _device.resolve(args.device)
    print(f"building Barabási–Albert graph with {args.nodes} nodes on {dev} ...")
    t0 = time.time()
    g = generators.barabasi_albert(args.nodes, m=3, seed=0, device=dev)
    deg = g.deg.cpu().numpy().astype(float)
    objective_true = (deg - deg.mean()) / (deg.std() + 1e-9)  # influence proxy
    fmax = float(objective_true.max())
    rng = np.random.default_rng(0)

    def obj(idx):
        return objective_true[idx] + 0.05 * rng.standard_normal(len(idx))

    print(f"  graph built in {time.time()-t0:.1f}s; max degree {int(deg.max())}")

    cfg = walks.WalkConfig(n_walkers=args.walkers, p_halt=0.15, l_max=5)
    tr = None
    if args.engine == "refit":
        print("sampling GRF walks (kernel initialisation, O(N)) ...")
        t0 = time.time()
        tr = walks.sample_walks(g, thompson._stream(1, thompson._WALK),
                                n_walkers=args.walkers, p_halt=0.15, l_max=5)
        _sync(dev)
        print(f"  {args.nodes} nodes × {tr.slots} slots in "
              f"{time.time()-t0:.1f}s ({tr.loads.numel() * 12 / 1e9:.2f} GB)")
    else:
        print("incremental engine: no full-graph trace — walk rows are "
              "sampled lazily per observation/query")

    mod = modulation.diffusion(l_max=5)
    t0 = time.time()
    if args.engine == "incremental":
        st = thompson.thompson_sampling_incremental(
            g, cfg, mod, obj, 1, n_init=args.init, n_steps=args.steps,
            refit_every=10, refit_steps=10, f_max=fmax,
            n_candidates=args.candidates,
        )
    else:
        st = thompson.thompson_sampling(
            tr, mod, obj, 1, n_init=args.init, n_steps=args.steps,
            refit_every=10, refit_steps=10, f_max=fmax,
        )
    _sync(dev)
    print(f"BO finished in {time.time()-t0:.1f}s; final simple regret "
          f"{st.regret[-1]:.4f}")

    for name, fn in (("random", baselines.random_search),
                     ("bfs", baselines.bfs_search),
                     ("dfs", baselines.dfs_search)):
        r = fn(g, obj, 0, args.init, args.steps, fmax)
        print(f"  baseline {name:7s}: final regret {r[-1]:.4f}")
    return st


if __name__ == "__main__":
    main()
