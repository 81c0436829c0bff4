"""Online GP serving quickstart on the PyTorch port: a 10⁶-node graph
behind the micro-batching engine.

    PYTHONPATH=src python -m repro_torch.examples.serve_gp                # 1M nodes
    PYTHONPATH=src python -m repro_torch.examples.serve_gp --nodes 20000  # small

The twin of examples/serve_gp.py, with the same flags and defaults.  It
runs on the CUDA card (``--device cpu`` runs the plain PyTorch versions
instead).  It builds a
ServeState (cached train features + m×m Gram Cholesky), streams
observations in via O(m²) incremental appends, refreshes α through the
escalation ladder, then serves batched mean/variance queries — no CG and
nothing N-scale in the hot path.  ``--fit-steps K`` runs K LML-ascent
steps on the observations first.  ``--record PATH`` streams a JSONL flight
record (spans, counters, CG taps) and prints the obs summary at exit;
``python -m repro_torch.obs.report --validate PATH`` checks it.

``--mesh N`` re-serves the state over an N-rank serving mesh
(``torch.distributed``, one spawned process per rank): the cached train
rows are split by rows, each rank answers from its block, and the script
checks the sharded answers against the single-device ones and drives a
``GPFleetLoop`` over the sharded state.  With ``--device cpu`` the ranks
are gloo processes on the CPU (the sharded answers are then held to 1e-6
of scale: the plain cross-Gram's einsum may round an entry differently at
another column width); on the card they are NCCL processes, one per card,
so one card runs ``--mesh 1`` (world size 1), and the answers must be bit
for bit the single-device ones:

    PYTHONPATH=src python -m repro_torch.examples.serve_gp --nodes 20000 --mesh 2 --device cpu

Chaos mode: with a fault plan in ``REPRO_FAULTS`` (resilience/faults.py,
e.g. ``REPRO_FAULTS=nan_payload:0.01,cg_stall:1``) the guards must absorb
every injected fault — this script's assertions are the gate: a finite
Cholesky, the escalated refit_alpha converged, every query answered
finitely.
"""
import argparse
import contextlib
import dataclasses
import tempfile
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import obs
from repro_torch import serving
from repro_torch.core import modulation, walks
from repro_torch.graphs import generators
from repro_torch.launch import mesh as _mesh
from repro_torch.resilience import faults


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--observe", type=int, default=50)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64,
                    help="engine slots per wave")
    ap.add_argument("--fit-steps", type=int, default=0,
                    help="LML-ascent steps on the observations before "
                         "serving (exercises the CG solve path)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="re-serve the state over an N-rank serving mesh "
                         "(gloo ranks on the CPU, one NCCL rank per card)")
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
    plan = faults.active()
    if plan is not None:
        print(f"chaos mode: injected fault plan [{plan.spec()}]")
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
    if int(state.rejected) > 0:
        print(f"  {int(state.rejected)} poisoned append(s) rejected by the "
              f"guards")

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

    if args.mesh > 0:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if backend == "nccl" and args.mesh > torch.cuda.device_count():
            raise SystemExit(
                f"--mesh {args.mesh} needs {args.mesh} cards (NCCL puts one "
                f"rank on each); this machine has {torch.cuda.device_count()}")
        print(f"re-serving over a {args.mesh}-rank {backend} serving mesh ...")
        host = _state_to(state, torch.device("cpu"))
        with tempfile.TemporaryDirectory() as d:
            _mesh.spawn_ranks(
                _serve_rank, args.mesh, init_method=f"file://{d}/store",
                backend=backend, timeout_s=600,
                args=(host, qnodes.astype(np.int32), args.batch,
                      min(args.queries, 128), backend))
    return state


def _state_to(state, dev):
    """``state`` with every tensor on ``dev`` (the ranks get a CPU copy)."""
    def to(x):
        return x.to(dev) if isinstance(x, torch.Tensor) else x

    g = state.graph
    packed = [walks.WalkTrace(*(to(t) for t in (x.cols, x.loads, x.lens)))
              if isinstance(x, walks.WalkTrace) else to(x)
              for x in serving.update._pack(state)]
    return dataclasses.replace(
        serving.update._unpack(state, packed), f=to(state.f),
        sigma_n2=to(state.sigma_n2),
        graph=dataclasses.replace(g, neighbors=to(g.neighbors),
                                  weights=to(g.weights), deg=to(g.deg)))


def _serve_rank(rank, host_state, qnodes, batch, n_queries, backend):
    """One rank of ``--mesh``: the sharded moments against the single-device
    ones, then a fleet over the sharded state (rank 0 reports)."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    state = _state_to(host_state, dev)
    sharded = serving.ShardedServeState(state)
    qsub = qnodes[:64]
    ms, vs = sharded.posterior_moments(qsub)
    m1, v1 = serving.posterior_moments(state, qsub)
    diff = max(float((ms - m1).abs().max()), float((vs - v1).abs().max()))
    scale = max(float(m1.abs().max()), float(v1.abs().max()))
    # The card's gram_block gives each entry the same sum at any column
    # width; the plain einsum may not (module docstring).
    limit = 0.0 if backend == "nccl" else 1e-6 * scale
    assert diff <= limit, \
        f"sharded moments diverge from single-device (max diff {diff})"
    fleet = serving.GPFleetLoop(sharded, batch=batch)
    reqs = [serving.GPRequest(nodes=qnodes[i:i + 16])
            for i in range(0, n_queries, 16)]
    t0 = time.time()
    fleet.run(reqs)
    assert all(r.done for r in reqs), "fleet left unanswered queries"
    if rank == 0:
        print(f"  sharded parity OK over {len(qsub)} nodes (max diff {diff:.3g}, "
              f"{'bitwise' if diff == 0 else f'limit {limit:.3g}'}); fleet "
              f"answered {fleet.served} queries in "
              f"{(time.time() - t0) * 1e3:.0f} ms")


if __name__ == "__main__":
    main()
