"""PyTorch port, fault injection (``repro_torch.resilience.faults``) against
the JAX package: plan parsing and spec round-trips, the resolution order,
the per-node hash bit for bit, the masks of the payload and Schur hooks,
the hooks' "no plan, no work" contract, and the guarded serving path under
the same plan.

Both packages get the same graph (grid2d(10, 10)), the same uint32 walk
seed, the same f and σ² and the same observations, as in
test_torch_serving.py.  Masks and the integer health flags are compared
exactly; the moments pass through a Cholesky and are held to 1e-4 of scale.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import interop, obs, serving  # noqa: E402
from repro_torch.core import walks as twalks  # noqa: E402
from repro_torch.resilience import faults  # noqa: E402
from repro_torch.serving import state as tstate  # noqa: E402
from repro_torch.serving import update as tupdate  # noqa: E402

CPU = "cpu"
TOL = 1e-4
S2 = 0.05
CAPACITY = 24
PLAN = "nan_payload:0.2,inf_payload:0.1,chol_fail:0.3,seed:3"


@pytest.fixture(autouse=True)
def clean_faults(monkeypatch):
    monkeypatch.delenv("REPRO_FAULTS", raising=False)
    faults.reset_faults()
    obs.reset_enabled()
    obs.REGISTRY.reset()
    yield
    faults.reset_faults()
    obs.reset_enabled()
    obs.REGISTRY.reset()


def close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def jx():
    """The JAX side: imported only here, so the file collects without JAX."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro import serving as jserving
    from repro.core import modulation as jmod
    from repro.core import walks as jwalks
    from repro.graphs import generators as jgen
    from repro.resilience import faults as jfaults

    class JX:
        pass

    j = JX()
    j.jax, j.jnp, j.serving, j.faults = jax, jnp, jserving, jfaults
    j.cfg = jwalks.WalkConfig(n_walkers=6, p_halt=0.25, l_max=4)
    j.g = jgen.grid2d(10, 10)
    m = jmod.diffusion(l_max=4)
    j.f = np.asarray(m(m.init(jax.random.PRNGKey(1))))
    j.key = jax.random.PRNGKey(0)
    j.seed = int(jwalks.walk_seed(j.key))
    j.tg = interop.graph_from_numpy(j.g.neighbors, j.g.weights, j.g.deg,
                                    device=CPU)
    j.tcfg = twalks.WalkConfig(n_walkers=6, p_halt=0.25, l_max=4)
    return j


def empties(j, s2=S2):
    je = j.serving.init_state(j.g, j.key, j.jnp.asarray(j.f), s2,
                              capacity=CAPACITY, cfg=j.cfg)
    te = serving.init_state(j.tg, j.seed, torch.from_numpy(j.f), s2, CAPACITY,
                            j.tcfg)
    return te, je


# ---------------------------------------------------------------------------
# FaultPlan: parsing, spec round-trips, resolution.
# ---------------------------------------------------------------------------


def test_parse_faults_roundtrip():
    p = faults.parse_faults("nan_payload:0.01,cg_stall:1,kill_at:5,seed:7")
    assert p == faults.FaultPlan(nan_payload=0.01, cg_stall=1, kill_at=5,
                                 seed=7)
    assert hash(p) is not None
    assert faults.parse_faults("") is None
    assert faults.parse_faults("off") is None
    assert faults.parse_faults(p.spec()) == p


@pytest.mark.parametrize("spec", [
    "nan_payload:0.01,cg_stall:1,kill_at:5,seed:7",
    "inf_payload:0.5, chol_fail:1.0",
    "kill_at:0,seed:2147483647",
    "cg_stall:9",
    PLAN,
])
def test_spec_roundtrip_matches_jax(jx, spec):
    t, j = faults.parse_faults(spec), jx.faults.parse_faults(spec)
    assert t.spec() == j.spec()
    assert faults.parse_faults(j.spec()) == t
    assert jx.faults.parse_faults(t.spec()) == j


def test_parse_faults_rejects_unknown_and_invalid():
    with pytest.raises(ValueError, match="unknown fault"):
        faults.parse_faults("nan_paylaod:0.1")
    with pytest.raises(ValueError, match="name:value"):
        faults.parse_faults("nan_payload")
    with pytest.raises(ValueError, match="probability"):
        faults.FaultPlan(nan_payload=1.5)
    with pytest.raises(ValueError, match="cg_stall"):
        faults.FaultPlan(cg_stall=-1)


def test_fault_resolution_order(monkeypatch):
    assert faults.active() is None                       # default: off
    monkeypatch.setenv("REPRO_FAULTS", "cg_stall:2")
    assert faults.active().cg_stall == 2                 # env
    faults.set_faults("cg_stall:3")
    assert faults.active().cg_stall == 3                 # global beats env
    with faults.use_faults("cg_stall:4"):
        assert faults.active().cg_stall == 4             # context beats global
        with faults.use_faults(None):
            assert faults.active() is None               # explicit off pin
        with faults.fault_scope(faults.FaultPlan(cg_stall=5)):
            assert faults.active().cg_stall == 5
    assert faults.active().cg_stall == 3
    faults.set_faults(None)
    assert faults.active() is None                       # global off beats env


# ---------------------------------------------------------------------------
# The hash and the hooks' masks, against JAX.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 9, 2**31 - 1])
def test_hash01_bit_equal_to_jax(jx, seed):
    ids = np.concatenate([
        np.arange(1 << 20, dtype=np.int32),
        np.random.default_rng(seed).integers(0, 2**31 - 1, 4096, dtype=np.int32),
        np.asarray([2**31 - 1], np.int32)])
    want = np.asarray(jx.jax.jit(lambda x: jx.faults._hash01(x, seed))(
        jx.jnp.asarray(ids)))
    got = faults._hash01(torch.from_numpy(ids), seed).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.dtype == np.float32 and 0.0 <= got.min() and got.max() <= 1.0


def test_corrupt_loads_and_guard_trace_masks_match_jax(jx):
    rng = np.random.default_rng(0)
    nodes = np.concatenate([np.arange(300), rng.integers(0, 10**6, 300)]).astype(np.int32)
    loads = rng.standard_normal((len(nodes), 5)).astype(np.float32)
    cols = rng.integers(0, 100, loads.shape).astype(np.int32)
    from repro.core.walks import WalkTrace as JTrace

    with faults.use_faults(PLAN), jx.faults.use_faults(PLAN):
        got = faults.corrupt_loads(torch.from_numpy(loads), torch.from_numpy(nodes))
        want = np.asarray(jx.faults.corrupt_loads(jx.jnp.asarray(loads),
                                                  jx.jnp.asarray(nodes)))
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
        np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
        np.testing.assert_array_equal(np.where(np.isfinite(want), want, 0),
                                      np.where(np.isfinite(got.numpy()), got.numpy(), 0))
        bad = ~np.isfinite(want).all(axis=1)
        assert 0 < bad.sum() < len(nodes)
        tg = faults.guard_trace(twalks.WalkTrace(torch.from_numpy(cols), got,
                                                 torch.from_numpy(cols)))
        jg = jx.faults.guard_trace(JTrace(jx.jnp.asarray(cols),
                                          jx.jnp.asarray(want),
                                          jx.jnp.asarray(cols)))
    np.testing.assert_array_equal(tg.loads.numpy(), np.asarray(jg.loads))
    assert not tg.loads[bad].any() and torch.isfinite(tg.loads).all()


def test_corrupt_schur_matches_jax(jx):
    d2 = np.float32(0.37)
    with faults.use_faults("chol_fail:0.3,seed:5"), \
            jx.faults.use_faults("chol_fail:0.3,seed:5"):
        got = [float(faults.corrupt_schur(torch.tensor(d2), torch.tensor(n)))
               for n in range(200)]
        want = [float(jx.faults.corrupt_schur(jx.jnp.asarray(d2),
                                              jx.jnp.asarray(n, jx.jnp.int32)))
                for n in range(200)]
    assert got == want
    assert 0 < sum(v < 0 for v in got) < 200


def test_corruption_is_deterministic_per_node(jx):
    te, _ = empties(jx)
    nodes = torch.arange(20, dtype=torch.int32)
    with faults.use_faults("nan_payload:0.3"):
        t1 = tstate.query_rows(te, nodes)
        t2 = tstate.query_rows(te, nodes)
    assert torch.equal(torch.isnan(t1.loads), torch.isnan(t2.loads))
    bad = ~torch.isfinite(t1.loads).all(dim=1)
    assert 0 < int(bad.sum()) < len(nodes)
    with faults.use_faults("nan_payload:0.3,seed:9"):
        t3 = tstate.query_rows(te, nodes)
    assert not torch.equal(bad, ~torch.isfinite(t3.loads).all(dim=1))


# ---------------------------------------------------------------------------
# No plan, no work: the hooks hand back their input and run no tensor op.
# ---------------------------------------------------------------------------


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("plan", [None, "cg_stall:2,kill_at:-1"])
def test_hooks_are_identity_without_a_plan(plan):
    loads = torch.randn(4, 3)
    nodes = torch.arange(4, dtype=torch.int32)
    d2 = torch.tensor(0.5)
    node = torch.tensor(3, dtype=torch.int32)
    tr = twalks.WalkTrace(torch.zeros(4, 3, dtype=torch.int32), loads,
                          torch.zeros(4, 3, dtype=torch.int32))
    with faults.use_faults(plan), _CountOps() as ops:
        assert faults.corrupt_loads(loads, nodes) is loads
        assert faults.corrupt_schur(d2, node) is d2
        assert faults.guard_trace(tr) is tr
        faults.kill_point("test")
        assert faults.should_stall(0) == (plan is not None)
    assert ops.n == 0


_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
          "__float__", "__index__")


@contextlib.contextmanager
def _count_reads():
    counts = {"n": 0}
    saved = {name: getattr(torch.Tensor, name) for name in _READS}

    def wrap(fn):
        def counted(self, *a, **k):
            counts["n"] += 1
            return fn(self, *a, **k)
        return counted

    for name, fn in saved.items():
        setattr(torch.Tensor, name, wrap(fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def test_hooks_add_no_host_read(jx, monkeypatch):
    """A serving workload makes as many host reads with the fault hooks as
    with the hooks replaced by the identity — with no plan, and with a plan
    and obs disabled (the hooks' counters are then not read)."""
    te, _ = empties(jx)
    nodes, ys = np.arange(0, 60, 5, dtype=np.int32), np.linspace(-1, 1, 12, dtype=np.float32)

    def workload():
        with _count_reads() as counts:
            st = serving.observe_batch(te, nodes, ys, auto_refit=False)
            serving.posterior_moments(st, torch.arange(30, dtype=torch.int32))
        return counts["n"]

    with faults.use_faults(None):
        hooked_off = workload()
    with faults.use_faults(PLAN):
        hooked_on = workload()
    for name in ("corrupt_loads", "corrupt_schur"):
        monkeypatch.setattr(faults, name, lambda x, *a: x)
    monkeypatch.setattr(faults, "guard_trace", lambda tr: tr)
    stubbed = workload()
    assert hooked_off == hooked_on == stubbed > 0


# ---------------------------------------------------------------------------
# The guarded serving path under a plan, against JAX.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("auto_refit", [False, True])
def test_guarded_serving_matches_jax_under_a_plan(jx, auto_refit):
    te, je = empties(jx)
    rng = np.random.default_rng(1)
    nodes = rng.choice(100, 20, replace=False).astype(np.int32)
    ys = rng.standard_normal(20).astype(np.float32)
    q = np.arange(100, dtype=np.int32)
    with faults.use_faults(PLAN), jx.faults.use_faults(PLAN):
        t = serving.observe_batch(te, nodes, ys, auto_refit=auto_refit)
        j = jx.serving.observe_batch(je, nodes, ys, auto_refit=auto_refit)
        tm, tv = serving.posterior_moments(t, torch.from_numpy(q))
        jm, jv = jx.serving.posterior_moments(j, q)
    for name in ("count", "rejected", "needs_refit", "overflow"):
        assert int(getattr(t, name)) == int(getattr(j, name)), name
    assert int(t.rejected) > 0
    np.testing.assert_array_equal(t.nodes.numpy(), np.asarray(j.nodes))
    if not auto_refit:
        # 15 chained jitter-clamped appends: the factor degrades in both
        # packages (what needs_refit reports), so only the flags compare.
        assert int(t.needs_refit) > 0
        return
    assert int(t.needs_refit) == 0
    assert torch.isfinite(t.chol).all() and torch.isfinite(tm).all()
    close(tm, jm)
    close(tv, jv)


def test_hook_counters_match_jax(jx):
    """With obs enabled, the injected-fault and sanitised-query counters
    equal JAX's for the same calls."""
    te, je = empties(jx)
    nodes = np.arange(0, 40, 2, dtype=np.int32)
    ys = np.zeros(20, np.float32)
    q = np.arange(100, dtype=np.int32)
    from repro import obs as jobs

    jobs.enable()
    obs.enable()
    try:
        with faults.use_faults(PLAN), jx.faults.use_faults(PLAN):
            t = serving.observe_batch(te, nodes, ys)
            serving.posterior_moments(t, torch.from_numpy(q))
            j = jx.serving.observe_batch(je, nodes, ys)
            jx.serving.posterior_moments(j, q)
            jx.jax.effects_barrier()
        tc = obs.REGISTRY.snapshot()["counters"]
        jc = jobs.REGISTRY.snapshot()["counters"]
    finally:
        jobs.reset_enabled()
        jobs.REGISTRY.reset()
    for name in ("faults.nan_payload.injected", "faults.chol_fail.injected",
                 "serving.query.sanitized", "serving.observe.rejected"):
        assert tc.get(name) == jc.get(name), (name, tc.get(name), jc.get(name))
    assert tc["serving.query.sanitized"] > 0


def test_ingest_is_pinned_fault_free(jx):
    te, _ = empties(jx)
    nodes = np.arange(0, 60, 3, dtype=np.int32)
    ys = np.ones(20, np.float32)
    with faults.use_faults("nan_payload:1.0"):
        st = serving.ingest(te, nodes, ys)
    ref = serving.ingest(te, nodes, ys)
    assert torch.equal(st.chol, ref.chol) and torch.isfinite(st.chol).all()
    assert tupdate._pack(st)[0] is st.nodes
