"""Closed-loop posterior sampling with Φ never held: each request is
``repro_torch.gp.posterior.pathwise_samples_chunked`` over every node of
the graph, with a fresh generator seed.  The walks are sampled again in
every request, ``chunk`` rows at a time, for the prior draw Φw and again
for the cross correction K̂_{·x}v; only the training rows Φ_x are held.
Set-up samples no trace: it holds the graph, the walk seed, the
observations and the modulation f.

Traffic parameters: ``observed`` (T observed nodes drawn from the seed),
``samples`` (S), ``chunk`` (rows a block), ``warm_requests``,
``check_outputs``, ``trace_requests``, ``reference`` (the reference CG's
``tol`` and ``max_iters``) and ``limits``.  The check runs the streamed
reference (``perfbench/reference/chunked.py``) over the kept requests: its
own walks, its own prior and noise draws from each request's seed, an
exact-to-float64 solve, and compares every sample of every node.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.drivers import common
from perfbench.harness import work as W
from perfbench.harness.runner import Output
from perfbench.reference import chunked, compare, gp

# Rows of Φ a block of the reference's streamed pass.
REF_BLOCK = 1 << 17


class Session:
    def __init__(self, config, traffic, seed, device, control):
        from repro_torch import solvers
        from repro_torch.core import modulation
        from repro_torch.core.walks import WalkConfig

        self.device = device
        self.config, self.traffic = config, traffic
        rng = np.random.default_rng(seed)
        self.graph = common.graph(config, device)
        n = self.n = self.graph.n_nodes
        w = config["walks"]
        self.cfg = WalkConfig(w["n_walkers"], w["p_halt"], w["l_max"])
        self.walk_seed = int(rng.integers(0, 2**32))
        self.train, self.y = common.observations(config, traffic, rng, n)
        self.request_base = int(rng.integers(0, 2**62))
        self.samples = int(traffic["samples"])
        self.chunk = int(traffic["chunk"])
        self.sigma2 = float(config["hyperparams"]["sigma_n2"])
        theta = common.theta(config, device, torch.float32)
        self.f = modulation.diffusion(l_max=w["l_max"])(theta)
        self.train_t = torch.from_numpy(self.train).to(device)
        self.y_t = torch.from_numpy(self.y).to(device)
        self.strategy = solvers.POSTERIOR_DEFAULT
        if control:
            self.strategy = self.strategy.with_(matvec_dtype="bfloat16")
        for i in range(int(traffic["warm_requests"])):
            self.request(-1 - i)

    def request(self, i: int) -> Output:
        from repro_torch.gp import posterior

        key = self.request_base + i
        gen = torch.Generator(device=self.device).manual_seed(key)
        out, iters, _ = posterior.pathwise_samples_chunked(
            self.graph, self.train_t, self.f, self.sigma2, self.y_t, gen,
            self.walk_seed, self.cfg, chunk=self.chunk,
            n_samples=self.samples, strategy=self.strategy,
            return_diagnostics=True)
        common.sync(self.device)
        return Output(key, out, [int(iters)], 1)

    def release(self) -> None:
        self.f = None

    def check(self, kept):
        """Reference samples of the kept requests, all from one streamed
        pass over Φ, compared entry by entry."""
        if not kept:
            return {}, {}
        dev, n, w = self.device, self.n, self.config["walks"]
        g = self.graph
        ref_g = chunked.Graph(g.neighbors, g.weights, g.deg, self.walk_seed,
                              w["n_walkers"], w["p_halt"], w["l_max"])
        theta = common.theta(self.config, dev)
        f = gp.diffusion_f(theta["log_beta"], theta["log_sigma_f"], w["l_max"])
        draws = []
        for out in kept:
            gen = torch.Generator(device=dev).manual_seed(out.key)
            wgt = torch.randn((n, self.samples), generator=gen, device=dev,
                              dtype=torch.float32).to(gp.F64)
            eps = torch.randn((len(self.train), self.samples), generator=gen,
                              device=dev, dtype=torch.float32).to(gp.F64)
            draws.append((wgt, eps))
        ref_cfg = self.traffic["reference"]
        refs, problem = chunked.pathwise_samples(
            ref_g, f, self.train_t, self.y_t.to(gp.F64), draws, self.sigma2,
            ref_cfg["tol"], ref_cfg["max_iters"], REF_BLOCK, sizes=True)
        del draws
        problem.update(n=n, t=len(self.train), s=self.samples,
                       max_deg=int(g.neighbors.shape[1]))
        numbers = {}
        for out, ref in zip(kept, refs):
            compare.worst(numbers, compare.sample_errors(out.value, ref))
        return numbers, problem


def work(p: dict, out: Output) -> dict:
    """Least seconds of one request's parts, from the problem's sizes.

    ``walk_sample``: the two streamed passes sample all N rows and Φ_x's T
    rows are sampled once; each sampled row writes its trace (column, load,
    length a slot) and reads its node id, and each distinct live column
    reads its graph row (neighbours, weights) and degree.  ``ell_spmv``:
    the prior draw Φw (every live slot gathers a row of w) and the cross's
    Φu with u = Φ_xᵀv, which is non-zero on Φ_x's columns only (the slots
    that land there).  ``khat_fused``: a K̂_xx product per CG iteration.
    ``call``: the request from its inputs (graph rows, nodes, y, w, eps)
    and output, with each product's operations once, as ``pathwise.work``
    counts them."""
    n, t, s, k = p["n"], p["t"], p["s"], p["k"]
    row_bytes = W.F32 * (2 * p["max_deg"] + 1)
    sampled = (2 * (W.TRACE_SLOT_BYTES * n * k + W.F32 * n
                    + row_bytes * p["touched"])
               + W.TRACE_SLOT_BYTES * t * k + W.F32 * t
               + row_bytes * p["touched_x"])
    prior = W.spmv(p["nnz"], p["touched"], n, s)
    cross = (W.SLOT_BYTES * p["nnz"] + W.F32 * s * (p["touched_x"] + n),
             2 * s * p["hits_x"])
    kxx = W.khat(p["nnz_x"], t, p["nnz_x"], p["nnz_x"], t, s, shared=True)
    call_bytes = (row_bytes * n + W.F32 * 2 * t + W.F32 * s * (n + t)
                  + W.F32 * s * n)
    call_flops = prior[1] + kxx[1] + cross[1]
    return {"walk_sample": W.least_s(sampled, 0),
            "ell_spmv": W.least_s(*prior) + W.least_s(*cross),
            "khat_fused": sum(out.iters) * W.least_s(*kxx),
            "call": W.least_s(call_bytes, call_flops)}


def setup(config: dict, traffic: dict, seed: int, device, control=False):
    return Session(config, traffic, seed, device, control)
