"""Closed-loop posterior sampling: each request is
``repro_torch.gp.posterior.pathwise_samples`` over every node of the graph,
with a fresh generator seed, on a walk trace sampled once in set-up, at the
configuration's hyperparameters.

Traffic parameters: ``observed`` (T observed nodes drawn from the seed, or
``"config"``: the configuration's own observation rule), ``samples`` (S),
``warm_requests``, ``check_outputs``, ``trace_requests``, ``reference``
(the reference CG's ``tol`` and ``max_iters``) and ``limits``.  The noise
on the observations comes from the seed.  The check runs the reference
(``perfbench/reference``) over each kept request: its own walks, its own
prior and noise draws from the request's seed, an exact-to-float64 solve,
and compares every sample of every node.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.drivers import common
from perfbench.harness import work as W
from perfbench.harness.runner import Output
from perfbench.reference import compare, gp, walks as ref_walks


class Session:
    def __init__(self, config, traffic, seed, device, control):
        from repro_torch import solvers
        from repro_torch.core import modulation, walks

        self.device = device
        self.config, self.traffic = config, traffic
        rng = np.random.default_rng(seed)
        self.graph = common.graph(config, device)
        n = self.n = self.graph.n_nodes
        w = config["walks"]
        self.walk_seed = int(rng.integers(0, 2**32))
        self.train, self.y = common.observations(config, traffic, rng, n)
        self.request_base = int(rng.integers(0, 2**62))
        self.samples = int(traffic["samples"])
        self.sigma2 = float(config["hyperparams"]["sigma_n2"])
        theta = common.theta(config, device, torch.float32)
        self.f = modulation.diffusion(l_max=w["l_max"])(theta)
        self.train_t = torch.from_numpy(self.train).to(device)
        self.y_t = torch.from_numpy(self.y).to(device)
        self.trace = walks.sample_walks(self.graph, self.walk_seed,
                                        w["n_walkers"], w["p_halt"],
                                        w["l_max"])
        self.strategy = solvers.POSTERIOR_DEFAULT
        if control:
            self.strategy = self.strategy.with_(matvec_dtype="bfloat16")
        for i in range(int(traffic["warm_requests"])):
            self.request(-1 - i)

    def request(self, i: int) -> Output:
        from repro_torch.gp import posterior

        key = self.request_base + i
        gen = torch.Generator(device=self.device).manual_seed(key)
        out, iters, _ = posterior.pathwise_samples(
            self.trace, self.train_t, self.f, self.sigma2, self.y_t, gen,
            n_samples=self.samples, strategy=self.strategy,
            return_diagnostics=True)
        common.sync(self.device)
        return Output(key, out, [int(iters)], 1)

    def release(self) -> None:
        self.trace = None
        self.f = None

    def check(self, kept):
        """Reference samples of each kept request, compared entry by entry."""
        dev, n, w = self.device, self.n, self.config["walks"]
        g = self.graph
        cols, loads, lens = ref_walks.sample(
            g.neighbors, g.weights, g.deg,
            torch.arange(n, dtype=torch.int32, device=dev), self.walk_seed,
            w["n_walkers"], w["p_halt"], w["l_max"])
        problem = common.trace_problem(cols, loads, self.train_t)
        problem.update(n=n, t=len(self.train), s=self.samples)
        theta = common.theta(self.config, dev)
        f = gp.diffusion_f(theta["log_beta"], theta["log_sigma_f"], w["l_max"])
        phi = gp.Features(cols, loads, lens, f, n)
        rows = self.train_t.long()
        phi_x = gp.Features(cols[rows], loads[rows], lens[rows], f, n)
        y = self.y_t.to(gp.F64)
        ref_cfg = self.traffic["reference"]
        numbers = {}
        for out in kept:
            gen = torch.Generator(device=dev).manual_seed(out.key)
            wgt = torch.randn((n, self.samples), generator=gen, device=dev,
                              dtype=torch.float32).to(gp.F64)
            eps = torch.randn((len(self.train), self.samples), generator=gen,
                              device=dev, dtype=torch.float32).to(gp.F64)
            ref = gp.pathwise_samples(
                phi, phi_x, self.train_t, y, wgt, eps, self.sigma2,
                ref_cfg["tol"], ref_cfg["max_iters"])
            del wgt, eps
            compare.worst(numbers, compare.sample_errors(out.value, ref))
            del ref
        return numbers, problem


def work(p: dict, out: Output) -> dict:
    """Least seconds of one request's parts, from the problem's sizes: the
    prior draw Φw (``ell_spmv``), its K̂ products (a K̂_xx product per CG
    iteration, then the cross correction K̂_{·x}v: ``khat_fused``) and the
    whole request from its inputs (trace, nodes, y, w, eps) and output
    (``call``)."""
    n, t, s = p["n"], p["t"], p["s"]
    prior = W.spmv(p["nnz"], p["touched"], n, s)
    kxx = W.khat(p["nnz_x"], t, p["nnz_x"], p["nnz_x"], t, s, shared=True)
    cross = W.khat(p["nnz_x"], t, p["nnz"], p["hits_x"], n, s, shared=False)
    call_bytes = (W.TRACE_SLOT_BYTES * p["nnz"] + W.F32 * 2 * t
                  + W.F32 * s * (n + t) + W.F32 * s * n)
    call_flops = prior[1] + kxx[1] + cross[1]
    return {"ell_spmv": W.least_s(*prior),
            "khat_fused": sum(out.iters) * W.least_s(*kxx) + W.least_s(*cross),
            "call": W.least_s(call_bytes, call_flops)}


def setup(config: dict, traffic: dict, seed: int, device, control=False):
    return Session(config, traffic, seed, device, control)
