"""The chunked posterior cell (``sphere-o1280.chunked``) on the CPU: whole
runs of a tiny copy against its streamed float64 reference, the
reference's streamed products against the whole trace's, the work counts,
and the per-layer metrics the cell reports."""
import dataclasses
import json

import pytest
import torch

from perfbench.drivers import common, pathwise_chunked
from perfbench.graphs import generators
from perfbench.harness import cli, runner, spec
from perfbench.harness.runner import Output
from perfbench.reference import chunked, gp, walks as ref_walks

from .conftest import tiny
from .test_perfbench_imports import loaded_after

CELL = "sphere-o1280.chunked"
SEED = 2**31 + 4567
# A few thousand nodes at the cell's widths (K = 900); 768-row chunks do
# not divide them.
N, CHUNK = 3000, 768


def tiny_chunked(**traffic):
    cell = spec.load_cell(CELL)
    cfg = json.loads(json.dumps(cell.config))
    tr = json.loads(json.dumps(cell.traffic))
    cfg["graph"]["n_nodes"] = N
    tr.update({"observed": 64, "samples": 8, "chunk": CHUNK, **traffic})
    return dataclasses.replace(cell, config=cfg, traffic=tr)


def run(device, control=False, trace=False):
    r = runner.run_cell(tiny_chunked(), SEED, 0.3, trace, device,
                        control=control)
    return r, cli.result_line(r, trace, device)


def test_config_keeps_the_wind_example_widths():
    o1280 = spec.load_cell(CELL).config
    mesh = spec.load_cell("sphere-1m.track").config
    assert o1280["graph"]["n_nodes"] == 4 * 1280 * (1280 + 9)
    for key in ("walks", "modulation", "hyperparams", "noise_std", "signal",
                "precision"):
        assert o1280[key] == mesh[key], key
    assert o1280["reduced"] == []
    assert {"graph.n_nodes", "hyperparams", "observed",
            "samples"} <= set(o1280["assumed"])


def test_sound_run_is_within_the_limits(cpu):
    r, line = run(cpu)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["checks"]) == {"max_err", "rms_err"}
    for c in line["checks"].values():
        assert c["value"] < c["limit"]
    assert r.problem["k"] == 900 and r.problem["n"] == N
    # the device-bound cell's request time also under the tighter bound
    m = line["metrics"]
    assert m["track_sample_ms"] == m["sample_ms"]


def test_control_fails(cpu):
    _, line = run(cpu, control=True)
    assert line["correct"] is False


def test_traced_line_reads_the_counters(cpu):
    _, line = run(cpu, trace=True)
    m = line["metrics"]
    assert m["cg_iters.sample"]["value"] > 0
    assert "launches.sample" in m          # no launches on the CPU
    # no device intervals on the CPU
    for name in ("walk_sample_roofline.chunked", "khat_fused_roofline.sample",
                 "device_idle_pct.sample"):
        assert name not in m


def test_cell_reports_the_sample_twins_and_its_sampler():
    """The chunked cell reads the ``.sample`` twins of the counters and
    rooflines that its kernels share, and ``walk_sample_roofline.chunked``
    for the one kernel only it runs on the request path."""
    names = {x.name for x in spec.load_cell(CELL).per_layer}
    assert names == {"cg_iters.sample", "launches.sample",
                     "ell_spmv_roofline.sample", "khat_fused_roofline.sample",
                     "device_idle_pct.sample", "mfu.sample",
                     "walk_sample_roofline.chunked"}


@pytest.mark.parametrize("control", [False, True])
def test_sphere_sample_cell_tiny_run(cpu, control):
    """``sphere-1m.sample``, the ring's traffic on the sphere: correct, and
    the control not."""
    cell = tiny(spec.load_cell("sphere-1m.sample"), samples=8, observed=64)
    assert cell.config["name"] == "grf-sphere-1m"
    r = runner.run_cell(cell, SEED, 0.3, False, cpu, control=control)
    assert cli.result_line(r, False, cpu)["correct"] is (not control)


def test_a_tiny_chunked_run_loads_no_jax():
    mods = loaded_after(
        "import torch\n"
        "from perfbench.harness import runner, cli\n"
        "from perfbench.tests.test_perfbench_chunked import tiny_chunked\n"
        "runner.run_cell(tiny_chunked(samples=2), 5, 0.1, False,\n"
        "                torch.device('cpu'))\n"
        "assert not cli.forbidden_modules()\n")
    assert not mods & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in mods


def test_chunked_reference_imports_nothing_of_the_port():
    mods = loaded_after("import perfbench.reference.chunked")
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("block", [700, N])
def test_streamed_products_equal_the_whole_trace(block):
    """The reference's streamed Φx and its sizes equal those of the whole
    trace held at once (``gp.Features``, ``common.trace_problem``)."""
    nb, wt, deg = (torch.from_numpy(a)
                   for a in generators.knn_sphere(N, 6, 0)[0])
    seed, f = 12345, gp.diffusion_f(torch.tensor(0.5, dtype=gp.F64),
                                    torch.tensor(0.1, dtype=gp.F64), 8)
    g = chunked.Graph(nb, wt, deg, seed, 100, 0.1, 8)
    x = torch.randn(N, 3, dtype=gp.F64, generator=torch.Generator().manual_seed(1))
    train = torch.tensor([5, 17, 400, 2999], dtype=torch.int32)
    cols, loads, lens = ref_walks.sample(nb, wt, deg,
                                         torch.arange(N, dtype=torch.int32),
                                         seed, 100, 0.1, 8)
    whole = gp.Features(cols, loads, lens, f, N).matvec(x)
    x_cols = torch.zeros(N, dtype=torch.bool)
    x_cols[cols[train.long()][loads[train.long()] != 0].long()] = True
    got, sizes = chunked.stream(g, f, x, block, x_cols)
    torch.testing.assert_close(got, whole, rtol=1e-12, atol=1e-12)
    want = common.trace_problem(cols, loads, train)
    assert sizes == {k: want[k] for k in ("nnz", "touched", "hits_x")}
    assert chunked.stream(g, f, x, block)[1] is None


def test_reference_samples_equal_the_monolithic_reference():
    """Eq. 12 by the streamed reference equals ``gp.pathwise_samples`` on
    the whole trace, for each of two draws."""
    nb, wt, deg = (torch.from_numpy(a)
                   for a in generators.ring(500, 2))
    seed, f = 99, gp.diffusion_f(torch.tensor(0.3, dtype=gp.F64),
                                 torch.tensor(0.2, dtype=gp.F64), 4)
    g = chunked.Graph(nb, wt, deg, seed, 6, 0.2, 4)
    train = torch.arange(3, 500, 25, dtype=torch.int32)
    t = len(train)
    gen = torch.Generator().manual_seed(3)
    y = torch.randn(t, dtype=gp.F64, generator=gen)
    draws = [(torch.randn(500, 4, dtype=gp.F64, generator=gen),
              torch.randn(t, 4, dtype=gp.F64, generator=gen))
             for _ in range(2)]
    got, sizes = chunked.pathwise_samples(g, f, train, y, draws, 0.05,
                                          1e-12, 500, 128, sizes=True)
    cols, loads, lens = ref_walks.sample(nb, wt, deg,
                                         torch.arange(500, dtype=torch.int32),
                                         seed, 6, 0.2, 4)
    phi = gp.Features(cols, loads, lens, f, 500)
    r = train.long()
    phi_x = gp.Features(cols[r], loads[r], lens[r], f, 500)
    for (w, eps), out in zip(draws, got):
        want = gp.pathwise_samples(phi, phi_x, train, y, w, eps, 0.05,
                                   1e-12, 500)
        torch.testing.assert_close(out, want, rtol=1e-9, atol=1e-9)
    assert sizes == {k: v for k, v in
                     common.trace_problem(cols, loads, train).items()}


def test_work_counts_by_hand():
    p = {"n": 10, "t": 2, "s": 4, "k": 3, "max_deg": 2, "nnz": 20,
         "touched": 9, "nnz_x": 5, "touched_x": 4, "hits_x": 7}
    got = pathwise_chunked.work(p, Output(0, None, [3], 1))
    row = 4 * 5                          # 2 neighbours, 2 weights, a degree
    sampled = 2 * (12 * 10 * 3 + 4 * 10 + row * 9) + 12 * 2 * 3 + 4 * 2 + row * 4
    assert got["walk_sample"] == pytest.approx(sampled / 3.35e12)
    prior_b, cross_b = 8 * 20 + 4 * 4 * (9 + 10), 8 * 20 + 4 * 4 * (4 + 10)
    assert got["ell_spmv"] == pytest.approx(
        max(prior_b / 3.35e12, 2 * 20 * 4 / 67e12)
        + max(cross_b / 3.35e12, 2 * 4 * 7 / 67e12))
    # K̂_xx: Φ_x's 5 slots read once, v and the output [2, 4]; 3 iterations
    kxx_b, kxx_f = 8 * 5 + 4 * 4 * (2 + 2), 2 * 4 * (5 + 5)
    assert got["khat_fused"] == pytest.approx(
        3 * max(kxx_b / 3.35e12, kxx_f / 67e12))
    call_b = row * 10 + 4 * 2 * 2 + 4 * 4 * (10 + 2) + 4 * 4 * 10
    # each product's operations once, whatever CG's count
    call_f = 2 * 20 * 4 + kxx_f + 2 * 4 * 7
    assert got["call"] == pytest.approx(max(call_b / 3.35e12,
                                            call_f / 67e12))
    more = pathwise_chunked.work(p, Output(0, None, [30], 1))
    assert more["call"] == got["call"]
