"""PyTorch port, the solve-escalation ladder (``repro_torch.solvers.escalate``
and ``refit_alpha``'s ladder) against the JAX package.

``escalation_ladder`` is compared with JAX's rung by rung.  JAX's
``solve_escalate`` cannot run under the installed jax (it calls
``jax.core.trace_state_clean``, which jax 0.9 lacks; ROADMAP Queue 3), so
the port's is held to its ladder and to a float64 dense solution (1e-4 of
scale): ``cg_stall:k`` resolves in exactly k extra rungs, exhaustion is
reported honestly with the best iterate, and the counters and events say
so.  ``refit_alpha``'s ladder runs in both packages: under ``cg_stall:1``
its events equal JAX's and α agrees to 1e-4 of scale.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop, obs, serving, solvers  # noqa: E402
from repro_torch.core import linops as tlin  # noqa: E402
from repro_torch.core import walks as twalks  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.resilience import faults  # noqa: E402

CPU = "cpu"
TOL = 1e-4
T = 30
N = 100
STRATEGIES = {
    "none": dict(preconditioner="none"),
    "jacobi": dict(preconditioner="jacobi"),
    "nystrom": dict(preconditioner="nystrom", precond_rank=8),
    "auto": dict(preconditioner="auto"),
    "bf16": dict(preconditioner="none", matvec_dtype="bfloat16", max_iters=32),
}


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    monkeypatch.delenv("REPRO_FAULTS", raising=False)
    faults.reset_faults()
    obs.reset_enabled()
    obs.REGISTRY.reset()
    yield
    faults.reset_faults()
    obs.reset_enabled()
    obs.REGISTRY.reset()


@pytest.fixture()
def ring_sink():
    obs.enable()
    sink = obs.RingBufferSink(256)
    obs.REGISTRY.add_sink(sink)
    yield sink
    obs.REGISTRY.remove_sink(sink)


def close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def ops():
    """A trace-backed ShiftedOperator in both packages over the same walk
    rows of grid2d(10, 10), and the port's bare callable of it."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.core import linops as jlin
    from repro.core import modulation as jmod
    from repro.core import walks as jwalks
    from repro.graphs import generators as jgen

    g = jgen.grid2d(10, 10)
    m = jmod.diffusion(l_max=4)
    f = np.asarray(m(m.init(jax.random.PRNGKey(1))))
    nodes = np.random.default_rng(0).choice(N, T, replace=False).astype(np.int32)
    jtr = jwalks.sample_walks_for_nodes(g, jnp.asarray(nodes), jax.random.PRNGKey(0),
                                        6, 0.25, 4)
    ttr = interop.trace_from_numpy(np.asarray(jtr.cols), np.asarray(jtr.loads),
                                   np.asarray(jtr.lens), device=CPU)
    jh = jlin.shifted(jtr, jnp.asarray(f), 0.05, N)
    th = tlin.shifted(ttr, torch.from_numpy(f), 0.05, N)
    dense = th(torch.eye(T)).double()
    return dict(jh=jh, th=th, dense=(dense + dense.T) / 2)


def _jax_ladder(strategy_kw, which, ops):
    from repro.solvers import strategy as jstrategy
    from repro.solvers.escalate import escalation_ladder

    h = {"none": None, "operator": ops["jh"], "callable": ops["jh"].__call__}[which]
    return escalation_ladder(jstrategy.SolveStrategy(**strategy_kw), h)


@pytest.mark.parametrize("which", ["none", "operator", "callable"])
@pytest.mark.parametrize("name", list(STRATEGIES))
def test_escalation_ladder_matches_jax(ops, name, which):
    h = {"none": None, "operator": ops["th"], "callable": ops["th"].__call__}[which]
    got = solvers.escalation_ladder(solvers.SolveStrategy(**STRATEGIES[name]), h)
    want = _jax_ladder(STRATEGIES[name], which, ops)
    assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in want]
    assert got[0] == solvers.SolveStrategy(**STRATEGIES[name])
    assert all(s.warm_start for s in got[1:])


def _spd(n=24, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    a = a @ a.T + n * np.eye(n)
    b = rng.standard_normal(n)
    matvec = torch.from_numpy(a.astype(np.float32)).__matmul__
    return matvec, torch.from_numpy(b.astype(np.float32)), np.linalg.solve(a, b)


def _counters():
    c = obs.REGISTRY.snapshot()["counters"]
    return {k: c.get(f"solver.escalation.{k}", 0)
            for k in ("attempts", "resolved", "forced_stalls", "exhausted")}


def _events(sink):
    return [{k: v for k, v in e.items() if k not in ("t", "seq")}
            for e in sink.events if e["type"] == "solver.escalation"]


@pytest.mark.parametrize("system, stalls", [
    ("callable", 0), ("callable", 1), ("callable", 2), ("operator", 3)])
def test_solve_escalate_resolves_a_forced_stall_in_k_rungs(ops, ring_sink,
                                                           system, stalls):
    base = solvers.SolveStrategy(preconditioner="none", tol=1e-7)
    if system == "callable":
        h, b, x64 = _spd()
    else:
        h = ops["th"]
        b = torch.from_numpy(np.random.default_rng(2).standard_normal(T).astype(np.float32))
        x64 = torch.linalg.solve(ops["dense"], b.double()).numpy()
    rungs = solvers.escalation_ladder(base, h)
    with faults.use_faults(f"cg_stall:{stalls}"):
        res = solvers.solve_escalate(h, b, base, backoff=0)
    assert bool(res.converged.all())
    close(res.x, x64)
    assert _counters() == dict(attempts=stalls + 1, resolved=int(stalls > 0),
                               forced_stalls=stalls, exhausted=0)
    assert len(_events(ring_sink)) == stalls + 1
    assert _events(ring_sink) == [dict(
        type="solver.escalation", site="solvers.solve", attempt=a,
        converged=a == stalls, forced_stall=a < stalls,
        preconditioner=rungs[a].preconditioner, max_iters=rungs[a].max_iters,
        matvec_dtype=rungs[a].matvec_dtype, resnorm_max=ev["resnorm_max"])
        for a, ev in zip(range(stalls + 1), _events(ring_sink))]


def test_solve_routes_escalate_and_caps_attempts(ring_sink):
    h, b, x64 = _spd(seed=1)
    with faults.use_faults("cg_stall:1"):
        res = solvers.solve(h, b, solvers.SolveStrategy(), escalate=True)
    assert bool(res.converged.all())
    close(res.x, x64)
    assert _counters()["attempts"] == 2
    obs.REGISTRY.reset()
    with faults.use_faults("cg_stall:99"):
        res = solvers.solve(h, b, solvers.SolveStrategy(), escalate=True,
                            max_attempts=2)
    assert not bool(res.converged.all())
    assert _counters() == dict(attempts=2, resolved=0, forced_stalls=2, exhausted=1)


def test_exhaustion_reports_honestly_with_the_best_iterate(ring_sink,
                                                           monkeypatch):
    """A stall deeper than the ladder exhausts it: converged stays False
    and the result is the attempt with the smallest worst-column
    residual."""
    h, b, x64 = _spd(seed=3)
    base = solvers.SolveStrategy(preconditioner="none", max_iters=3, tol=1e-12)
    seen = []
    real = solvers.escalate._base_solve

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    monkeypatch.setattr(solvers.escalate, "_base_solve", spy)
    with faults.use_faults("cg_stall:9"):
        res = solvers.solve_escalate(h, b, base, backoff=0)
    n_rungs = len(solvers.escalation_ladder(base, h))
    assert len(seen) == n_rungs == 3
    assert not bool(res.converged.any())
    best = min(seen, key=lambda r: float(r.resnorm.max()))
    assert torch.equal(res.x, best.x)
    assert _counters() == dict(attempts=3, resolved=0, forced_stalls=3, exhausted=1)
    assert [e["converged"] for e in _events(ring_sink)] == [False] * 3


def test_prebuilt_precond_applies_to_the_first_attempt_only(ops):
    calls = {"n": 0}
    jac = solvers.jacobi_precond(torch.diagonal(ops["dense"]).float())

    def counted(v):
        calls["n"] += 1
        return jac(v)

    b = torch.ones(T)
    with faults.use_faults("cg_stall:1"):
        res = solvers.solve_escalate(ops["th"], b, solvers.SolveStrategy(),
                                     precond=counted, backoff=0)
    first = calls["n"]
    assert first > 0 and bool(res.converged.all())
    with faults.use_faults("cg_stall:0"):
        solvers.solve_escalate(ops["th"], b, solvers.SolveStrategy(),
                               precond=counted, backoff=0)
    assert calls["n"] == 2 * first


def test_refit_alpha_escalation_matches_jax():
    """Under cg_stall:1 the serving ladder resolves in one extra rung in
    both packages, with the same events, and α agrees to 1e-4."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro import obs as jobs
    from repro import serving as jserving
    from repro.core import modulation as jmod
    from repro.core import walks as jwalks
    from repro.graphs import generators as jgen
    from repro.resilience import faults as jfaults

    g = jgen.grid2d(10, 10)
    m = jmod.diffusion(l_max=4)
    f = np.asarray(m(m.init(jax.random.PRNGKey(1))))
    key = jax.random.PRNGKey(0)
    cfg = jwalks.WalkConfig(n_walkers=6, p_halt=0.25, l_max=4)
    tg = interop.graph_from_numpy(g.neighbors, g.weights, g.deg, device=CPU)
    je = jserving.init_state(g, key, jnp.asarray(f), 0.05, capacity=16, cfg=cfg)
    te = serving.init_state(tg, int(jwalks.walk_seed(key)), torch.from_numpy(f),
                            0.05, 16, twalks.WalkConfig(6, 0.25, 4))
    rng = np.random.default_rng(1)
    nodes = rng.choice(N, 10, replace=False).astype(np.int32)
    ys = rng.standard_normal(10).astype(np.float32)
    js = jserving.observe_batch(je, nodes, ys)
    ts = serving.observe_batch(te, nodes, ys)

    tsink, jsink = obs.RingBufferSink(64), jobs.RingBufferSink(64)
    obs.enable()
    jobs.enable()
    obs.REGISTRY.add_sink(tsink)
    jobs.REGISTRY.add_sink(jsink)
    try:
        with faults.use_faults("cg_stall:1"), jfaults.use_faults("cg_stall:1"):
            t2, _, tconv = serving.refit_alpha(ts, f=f * 1.05, escalate=True,
                                               return_diagnostics=True)
            j2, _, jconv = jserving.refit_alpha(js, f=f * 1.05, escalate=True,
                                                return_diagnostics=True)
        tc = obs.REGISTRY.snapshot()["counters"]
        jc = jobs.REGISTRY.snapshot()["counters"]
        jev = [{k: v for k, v in e.items() if k not in ("t", "seq")}
               for e in jsink.events if e["type"] == "solver.escalation"]
    finally:
        jobs.REGISTRY.remove_sink(jsink)
        jobs.reset_enabled()
        jobs.REGISTRY.reset()
    assert tconv and bool(jconv)
    tev = _events(tsink)
    assert tev == jev and len(tev) == 2
    assert [e["site"] for e in tev] == ["serving.refit_alpha"] * 2
    for k in ("attempts", "resolved", "forced_stalls"):
        name = f"solver.escalation.{k}"
        assert tc[name] == jc[name], name
    assert tc["solver.escalation.resolved"] == 1
    close(t2.alpha, j2.alpha)


@pytest.fixture()
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_gpu_solve_escalate_launches_woodbury(cuda):
    """On the card, a stalled Nyström solve on a trace-backed operator
    (applied through woodbury_apply) resolves on its next rung, and agrees
    with the same escalation on the CPU."""
    from repro_torch.core import modulation
    from repro_torch.graphs import generators

    out = {}
    for dev in (torch.device("cpu"), cuda):
        g = generators.ring(4096, k=3, device=dev)
        f = modulation.diffusion(l_max=4)(modulation.diffusion(l_max=4).init(device=dev))
        tr = twalks.sample_walks_for_nodes(g, torch.arange(256, device=dev),
                                           1234, 8, 0.2, 4)
        h = tlin.shifted(tr, f, 0.05, 4096)
        b = torch.from_numpy(np.random.default_rng(0).standard_normal(256)
                             .astype(np.float32)).to(dev)
        dispatch.reset_launch_counts()
        with faults.use_faults("cg_stall:1"):
            res = solvers.solve_escalate(
                h, b, solvers.SolveStrategy(tol=1e-6, preconditioner="nystrom",
                                            precond_rank=32), backoff=0)
        out[dev.type] = (res, dispatch.launch_counts())
    res, counts = out["cuda"]
    assert bool(res.converged.all())
    assert counts["woodbury_apply"] > 0 and counts["khat_fused"] > 0
    close(res.x.cpu(), out["cpu"][0].x, 1e-4)
