"""The reference's LML surrogate, whose fit states the track cell's
hyperparameters, against the exact dense LML; and the graph cache."""
import math

import numpy as np
import pytest
import torch

from perfbench import calibrate
from perfbench.drivers import common
from perfbench.graphs import generators
from perfbench.harness import spec
from perfbench.reference import gp, walks as ref_walks

from .conftest import tiny


def test_surrogate_gradient_is_the_exact_lml_gradient():
    """With the probes √T·I the surrogate's trace term is exact, so its
    gradient is that of ½yᵀH⁻¹y + ½ log det H."""
    nb, wt, deg = (torch.from_numpy(a) for a in generators.ring(40, 2))
    train = torch.arange(0, 40, 4, dtype=torch.int32)
    cols, loads, lens = ref_walks.sample(nb, wt, deg, train, 99, 6, 0.2, 4)
    t = len(train)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(t))
    theta = {"log_beta": torch.tensor(0.3, dtype=gp.F64),
             "log_sigma_f": torch.tensor(0.2, dtype=gp.F64),
             "log_sigma_n": torch.tensor(-1.1, dtype=gp.F64)}
    z = math.sqrt(t) * torch.eye(t, dtype=gp.F64)
    _, datafit, grads, _ = gp.surrogate_step(cols, loads, lens, 40, theta, y,
                                             z, 4, 1e-12, 500)
    leaves = {k: v.clone().requires_grad_(True) for k, v in theta.items()}
    f = gp.diffusion_f(leaves["log_beta"], leaves["log_sigma_f"], 4)
    phi = torch.zeros(t, 40, dtype=gp.F64)
    live = loads != 0
    rows = torch.arange(t)[:, None].expand_as(cols)[live]
    phi = phi.index_put((rows, cols[live].long()),
                        loads[live].to(gp.F64) * f[lens[live].long()],
                        accumulate=True)
    h = phi @ phi.T + torch.exp(2 * leaves["log_sigma_n"]) * torch.eye(t, dtype=gp.F64)
    exact = 0.5 * y @ torch.linalg.solve(h, y) + 0.5 * torch.logdet(h)
    want = torch.autograd.grad(exact, list(leaves.values()))
    assert datafit == pytest.approx(
        float(0.5 * y @ torch.linalg.solve(h.detach(), y)), rel=1e-9)
    for k, g in zip(leaves, want):
        assert float(grads[k]) == pytest.approx(float(g), rel=1e-7, abs=1e-9)


def test_fit_runs_and_moves_the_hyperparameters(cpu):
    cell = tiny(spec.load_cell("sphere-1m.track"))
    recs = list(calibrate.fit(cell, 5, 3, cpu))
    assert [r["step"] for r in recs] == [1, 2, 3]
    first, last = recs[0]["hyperparams"], recs[-1]["hyperparams"]
    assert all(v > 0 and math.isfinite(v) for v in last.values())
    assert last != first and all(r["cg_iters"] > 0 for r in recs)


def test_graph_cache_builds_once_and_loads_the_same(tmp_path):
    cfg = {"graph": {"kind": "knn_sphere", "n_nodes": 500, "k": 6, "seed": 3}}
    common._host_graph.cache_clear()
    built = common.host_graph(cfg, tmp_path)
    assert len(list(tmp_path.glob("*.npz"))) == 1
    common._host_graph.cache_clear()
    loaded = common.host_graph(cfg, tmp_path)
    common._host_graph.cache_clear()
    for a, b in zip(built, loaded):
        np.testing.assert_array_equal(a, b)
    ring = {"graph": {"kind": "ring", "n_nodes": 50, "k": 2}}
    assert common.host_graph(ring, tmp_path)[3] is None
    common._host_graph.cache_clear()
    assert common.host_graph(ring, tmp_path)[3] is None
    common._host_graph.cache_clear()
