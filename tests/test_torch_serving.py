"""PyTorch port, online serving: ServeState updates, closed-form moments,
the joint Thompson draw and the micro-batching engine, against the JAX
package on the same inputs.

Both packages get the same graph (grid2d(10, 10)), the same uint32 walk
seed (JAX's ``walk_seed(key)`` value handed to the port), the same f and
σ² and the same observations; the joint draw is fed JAX's own standard
normals.  JAX runs its "xla" path.

Tolerances: Gram entries agree to float32 rounding; everything downstream
passes through a Cholesky factor and triangular solves of a 24×24 system,
held to 1e-4 of the result's scale.  refit_alpha's CG counts may differ by
one iteration.  Within the port, incremental appends and a from-scratch
ingest are held to the same 1e-4, and the engine's answers equal
posterior_moments on the same nodes exactly (the same function of the
same wave).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import serving as jserving  # noqa: E402
from repro.core import modulation as jmod  # noqa: E402
from repro.core import walks as jwalks  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import state as jstate  # noqa: E402
from repro_torch import interop, serving  # noqa: E402
from repro_torch.core import walks as twalks  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import state as tstate  # noqa: E402

CPU = "cpu"
TOL = 1e-4
J_CFG = jwalks.WalkConfig(n_walkers=6, p_halt=0.25, l_max=4)
T_CFG = twalks.WalkConfig(n_walkers=6, p_halt=0.25, l_max=4)
S2 = 0.05
CAPACITY = 24


def close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def same_state(t, j, tol=TOL):
    """The port's ServeState equals the JAX one: integer leaves exactly,
    float leaves to ``tol`` of scale."""
    assert int(t.count) == int(j.count)
    for name in ("overflow", "rejected", "needs_refit"):
        assert int(getattr(t, name)) == int(getattr(j, name)), name
    np.testing.assert_array_equal(t.nodes.numpy(), np.asarray(j.nodes))
    np.testing.assert_array_equal(t.trace.cols.numpy(), np.asarray(j.trace.cols))
    np.testing.assert_array_equal(t.trace.lens.numpy(), np.asarray(j.trace.lens))
    close(t.trace.loads, j.trace.loads, 1e-6)
    close(t.y, j.y, 1e-6)
    close(t.chol, j.chol, tol)
    close(t.alpha, j.alpha, tol)


class Setup:
    def __init__(self):
        self.jg = jgen.grid2d(10, 10)
        self.tg = interop.graph_from_numpy(self.jg.neighbors, self.jg.weights,
                                           self.jg.deg, device=CPU)
        jm = jmod.diffusion(l_max=J_CFG.l_max)
        self.jf = jm(jm.init(jax.random.PRNGKey(1)))
        self.key = jax.random.PRNGKey(0)
        self.seed = int(jwalks.walk_seed(self.key))
        rng = np.random.default_rng(0)
        self.obs = rng.choice(100, 14, replace=False).astype(np.int32)
        self.y = rng.standard_normal(14).astype(np.float32)

    def empty(self, s2=S2, f_scale=1.0):
        f = np.asarray(self.jf) * f_scale
        j = jserving.init_state(self.jg, self.key, jnp.asarray(f), s2,
                                capacity=CAPACITY, cfg=J_CFG)
        t = serving.init_state(self.tg, self.seed, torch.from_numpy(f), s2,
                               CAPACITY, T_CFG)
        return t, j


@pytest.fixture(scope="module")
def s():
    return Setup()


def test_init_and_ingest_match_jax(s):
    t0, j0 = s.empty()
    assert t0.seed == int(j0.seed)
    same_state(t0, j0)
    same_state(serving.ingest(t0, s.obs, s.y), jserving.ingest(j0, s.obs, s.y))


def test_observe_batch_and_observe_match_jax(s):
    t0, j0 = s.empty()
    t = serving.observe_batch(t0, s.obs[:10], s.y[:10])
    j = jserving.observe_batch(j0, s.obs[:10], s.y[:10])
    same_state(t, j)
    for node, y_t in zip(s.obs[10:], s.y[10:]):
        t = serving.observe(t, int(node), float(y_t))
        j = jserving.observe(j, int(node), float(y_t))
    same_state(t, j)
    # The input state is untouched (functional updates).
    assert int(t0.count) == 0 and torch.equal(t0.chol, torch.eye(CAPACITY))


@pytest.mark.parametrize("auto_refit", [False, True])
def test_near_duplicate_append_flags_and_refits_like_jax(s, auto_refit):
    """At tiny noise a repeated node's Schur complement is under the jitter
    floor: needs_refit bumps, and auto_refit answers with a refactorisation."""
    t0, j0 = s.empty(s2=1e-6)
    t = serving.observe_batch(t0, s.obs[:6], s.y[:6])
    j = jserving.observe_batch(j0, s.obs[:6], s.y[:6])
    dup = [int(s.obs[2])]
    t = serving.observe_batch(t, dup, [0.4], auto_refit=auto_refit)
    j = jserving.observe_batch(j, dup, [0.4], auto_refit=auto_refit)
    assert int(t.needs_refit) == int(j.needs_refit) == (0 if auto_refit else 1)
    assert bool(torch.isfinite(t.chol).all())
    same_state(t, j, tol=1e-3 if not auto_refit else TOL)


def test_overflow_policies_match_jax(s):
    t0, j0 = s.empty()
    nodes = np.arange(CAPACITY, dtype=np.int32) * 4
    ys = np.linspace(-1, 1, CAPACITY).astype(np.float32)
    t = serving.ingest(t0, nodes, ys)
    j = jserving.ingest(j0, nodes, ys)
    with pytest.raises(ValueError, match="capacity"):
        serving.observe_batch(t, [1], [1.0])
    for policy in ("forget_oldest", "reject"):
        same_state(serving.observe_batch(t, [1, 2], [1.0, 2.0], on_overflow=policy),
                   jserving.observe_batch(j, [1, 2], [1.0, 2.0], on_overflow=policy))
    with pytest.raises(ValueError, match="on_overflow"):
        serving.observe_batch(t, [1], [1.0], on_overflow="evict")


def test_forget_and_forget_batch_match_jax(s):
    t0, j0 = s.empty()
    t = serving.ingest(t0, s.obs, s.y)
    j = jserving.ingest(j0, s.obs, s.y)
    for slot in (0, 5, len(s.obs) - 1):
        same_state(serving.forget(t, slot), jserving.forget(j, slot))
    same_state(serving.forget_batch(t, [3, 0, 7]), jserving.forget_batch(j, [3, 0, 7]))
    # ... and a downdate equals refactorising the remaining rows.
    keep = np.delete(np.arange(len(s.obs)), 5)
    want = serving.ingest(t0, s.obs[keep], s.y[keep])
    got = serving.forget(t, 5)
    close(got.chol, want.chol)
    close(got.alpha, want.alpha)


def test_refit_and_refit_alpha_match_jax(s):
    t0, j0 = s.empty()
    t = serving.ingest(t0, s.obs, s.y)
    j = jserving.ingest(j0, s.obs, s.y)
    f2 = np.asarray(s.jf) * 1.3
    same_state(serving.refit(t, f=torch.from_numpy(f2), sigma_n2=0.11),
               jserving.refit(j, f=jnp.asarray(f2), sigma_n2=0.11))
    for escalate in (False, True):
        ta, t_it, t_ok = serving.refit_alpha(
            t, f=torch.from_numpy(f2), sigma_n2=0.11, return_diagnostics=True,
            escalate=escalate)
        ja, j_it, j_ok = jserving.refit_alpha(
            j, f=jnp.asarray(f2), sigma_n2=0.11, return_diagnostics=True,
            escalate=escalate)
        close(ta.alpha, ja.alpha)
        assert abs(int(t_it) - int(j_it)) <= 1 and bool(t_ok) == bool(j_ok)
    # Mean-serving fast path == the refactorised α.
    close(ta.alpha, serving.refit(t, f=torch.from_numpy(f2), sigma_n2=0.11).alpha)


def test_posterior_moments_match_jax(s):
    t0, j0 = s.empty()
    t = serving.observe_batch(t0, s.obs, s.y)
    j = jserving.observe_batch(j0, s.obs, s.y)
    q = np.arange(0, 100, 3, dtype=np.int32)
    tm, tv = serving.posterior_moments(t, torch.from_numpy(q))
    jm, jv = jserving.posterior_moments(j, jnp.asarray(q))
    close(tm, jm)
    close(tv, jv)
    assert bool((tv >= 0).all())


def test_joint_draw_tail_fed_jax_normals_matches_jax(s):
    t0, j0 = s.empty()
    t = serving.observe_batch(t0, s.obs, s.y)
    j = jserving.observe_batch(j0, s.obs, s.y)
    q = np.arange(1, 100, 4, dtype=np.int32)
    key = jax.random.PRNGKey(5)
    want = jengine.thompson_draw(j, jnp.asarray(q), key, n_samples=3)
    eps = np.array(jax.random.normal(key, (len(q), 3), dtype=jnp.float32))
    trace_q, vals_q, mean, v = tstate._cross_solve(t, torch.from_numpy(q))
    got = tengine._joint_draw_tail(trace_q, vals_q, mean, v, torch.from_numpy(eps))
    close(got, want)
    draw = serving.thompson_draw(t, q, torch.Generator().manual_seed(0), n_samples=2)
    assert draw.shape == (len(q), 2) and bool(torch.isfinite(draw).all())
    # The marginal fallback: a covariance no jitter rescues still draws finitely.
    bad = tengine._joint_draw_tail(trace_q, vals_q, mean, v * 1e3,
                                   torch.from_numpy(eps))
    assert bool(torch.isfinite(bad).all())
    _, j_vq, j_mean, j_v = jstate._cross_solve(j, jnp.asarray(q))
    close(vals_q, j_vq, 1e-6)
    close(v, j_v)


def test_incremental_appends_match_ingest_in_port(s):
    t0, _ = s.empty()
    inc = t0
    for i in range(0, 14, 5):
        inc = serving.observe_batch(inc, s.obs[i:i + 5], s.y[i:i + 5])
    ref = serving.ingest(t0, s.obs, s.y)
    assert torch.equal(inc.nodes, ref.nodes)
    close(inc.chol, ref.chol)
    close(inc.alpha, ref.alpha)
    assert torch.equal(inc.chol[14:, 14:], torch.eye(CAPACITY - 14))


def test_serve_loop_answers_equal_posterior_moments(s):
    t0, _ = s.empty()
    t = serving.observe_batch(t0, s.obs, s.y)
    q = np.arange(0, 100, 3, dtype=np.int32)          # 34 nodes, batch 8
    want_mean, want_var = serving.posterior_moments(t, torch.from_numpy(q))
    loop = serving.GPServeLoop(t, batch=8, max_pending=2)
    reqs = [serving.GPRequest(nodes=q[:5]), serving.GPRequest(nodes=q[5:20]),
            serving.GPRequest(nodes=q[20:])]
    assert loop.submit(reqs[0]) and loop.submit(reqs[1])
    assert not loop.submit(reqs[2])                    # backpressure
    assert loop.drain() == 20
    loop.run([reqs[2]])
    assert all(r.done for r in reqs)
    got_mean = np.concatenate([r.mean for r in reqs])
    got_var = np.concatenate([r.var for r in reqs])
    np.testing.assert_allclose(got_mean, want_mean.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_var, want_var.numpy(), rtol=1e-6, atol=1e-7)
    assert np.isfinite(np.concatenate([r.draw for r in reqs])).all()
    assert serving.GPRequest(nodes=[]).done
