"""Online GP serving quickstart on the PyTorch port: a 10⁶-node graph
behind the micro-batching engine.

    PYTHONPATH=src python -m repro_torch.examples.serve_gp                # 1M nodes
    PYTHONPATH=src python -m repro_torch.examples.serve_gp --nodes 20000  # small

The twin of examples/serve_gp.py, with the same flags and defaults except
those listed under "left out" in --help.  It runs on the CUDA card
(``--device cpu`` runs the plain PyTorch versions instead).  It builds a
ServeState (cached train features + m×m Gram Cholesky), streams
observations in via O(m²) incremental appends, refreshes α through the
escalation ladder, then serves batched mean/variance queries — no CG and
nothing N-scale in the hot path.  ``--fit-steps K`` runs K LML-ascent
steps on the observations first.  ``--record PATH`` streams a JSONL flight
record (spans, counters, CG taps) and prints the obs summary at exit;
``python -m repro_torch.obs.report --validate PATH`` checks it.
"""
import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import obs
from repro_torch import serving
from repro_torch.core import modulation, walks
from repro_torch.graphs import generators

LEFT_OUT = ("left out of the port so far: --mesh (sharded serving and the "
            "fleet) and the REPRO_FAULTS chaos mode")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 epilog=LEFT_OUT)
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--observe", type=int, default=50)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64,
                    help="engine slots per wave")
    ap.add_argument("--fit-steps", type=int, default=0,
                    help="LML-ascent steps on the observations before "
                         "serving (exercises the CG solve path)")
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
    signal = (deg - deg.mean()) / (deg.std() + 1e-9)   # influence proxy
    rng = np.random.default_rng(0)
    print(f"  built in {time.time()-t0:.1f}s")

    cfg = walks.WalkConfig(n_walkers=8, p_halt=0.2, l_max=5)
    mod = modulation.diffusion(l_max=cfg.l_max)
    f = mod(mod.init(device=dev))
    seed = walks.walk_seed(torch.Generator().manual_seed(0))

    obs_nodes = rng.choice(args.nodes, args.observe, replace=False).astype(np.int32)
    y = (signal[obs_nodes]
         + 0.05 * rng.standard_normal(args.observe)).astype(np.float32)
    sigma_n2 = 0.05

    if args.fit_steps > 0:
        from repro_torch.gp import mll

        print(f"fitting hyperparameters for {args.fit_steps} steps ...")
        trace_x = walks.sample_walks_for_nodes(
            g, torch.from_numpy(obs_nodes), seed, cfg.n_walkers, cfg.p_halt,
            cfg.l_max, cfg.reweight, cfg.scheme,
        )
        res = mll.fit_hyperparams(
            trace_x, mod, torch.from_numpy(y).to(dev), g.n_nodes,
            torch.Generator().manual_seed(2), steps=args.fit_steps,
            chunk=args.fit_steps, init_noise=float(np.sqrt(sigma_n2)),
        )
        f = mod(res.params["mod"])
        sigma_n2 = float(mll.noise_var(res.params))
        last = res.history[-1]
        print(f"  step {last['step']}: loss {last['loss']:.3f}, "
              f"sigma_n2 {last['sigma_n2']:.4f}, cg_iters {last['cg_iters']}")

    # Empty state: train rows are sampled lazily per observation, query
    # rows lazily per wave.
    state = serving.init_state(g, seed, f, sigma_n2, args.capacity, cfg)

    print(f"streaming {args.observe} observations "
          f"(incremental Cholesky appends) ...")
    t0 = time.time()
    state = serving.observe_batch(state, obs_nodes, y)
    _sync(dev)
    t_first = time.time() - t0
    state = serving.observe(state, int(rng.integers(args.nodes)),
                            float(rng.standard_normal()))
    _sync(dev)
    t0 = time.time()
    state = serving.observe(state, int(rng.integers(args.nodes)),
                            float(rng.standard_normal()))
    _sync(dev)
    print(f"  batch ingested in {t_first:.2f}s; "
          f"steady-state observe() {1e3*(time.time()-t0):.1f} ms")
    assert bool(torch.isfinite(state.chol).all()), \
        "guarded appends left a non-finite Cholesky"

    state, alpha_iters, alpha_conv = serving.refit_alpha(
        state, escalate=True, return_diagnostics=True
    )
    assert alpha_conv, "escalated refit_alpha did not converge"
    print(f"  refit_alpha converged in {int(alpha_iters)} iters "
          f"(escalation ladder armed)")

    print(f"serving {args.queries} queries through batch-{args.batch} "
          f"waves ...")
    loop = serving.GPServeLoop(state, batch=args.batch)
    qnodes = rng.choice(args.nodes, args.queries, replace=False)
    requests = [serving.GPRequest(nodes=qnodes[i:i + 16])
                for i in range(0, args.queries, 16)]
    loop.run(requests)          # first pass: lazy CUDA initialisation
    requests = [serving.GPRequest(nodes=qnodes[i:i + 16])
                for i in range(0, args.queries, 16)]
    t0 = time.time()
    loop.run(requests)
    dt = time.time() - t0
    assert all(r.done for r in requests), "unanswered queries"
    mean = np.concatenate([r.mean for r in requests])
    var = np.concatenate([r.var for r in requests])
    answered = int((np.isfinite(mean) & np.isfinite(var) & (var >= 0)).sum())
    assert answered == len(mean), \
        f"only {answered}/{len(mean)} queries answered finitely"
    best = qnodes[int(np.argmax(mean))]
    print(f"  {args.queries} queries in {dt*1e3:.0f} ms "
          f"({args.queries/dt:.0f} queries/s)")
    print(f"  top posterior mean {mean.max():.3f} at node {best} "
          f"(degree {int(deg[best])}); mean predictive sd "
          f"{np.sqrt(var).mean():.3f}")

    m2, v2 = serving.posterior_moments(state, qnodes[:8].astype(np.int32))
    print(f"  posterior_moments head: mean {m2.cpu().numpy()[:3].round(3)}, "
          f"var {v2.cpu().numpy()[:3].round(3)}")
    return state


if __name__ == "__main__":
    main()
