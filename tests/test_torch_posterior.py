"""PyTorch port, features → operators → CG → posterior, against the JAX package.

Both packages get the same walk trace (sampled with the same uint32 seed, or
handed across with ``interop``), the same modulation parameters and, for the
pathwise samples, the exact w/eps JAX draws.  The JAX side runs its "xla"
path.

Tolerances: single sparse products sum float32 terms in another order than
XLA: rtol = atol = 1e-5 of the result's scale.  Results that pass through
CG (tol 1e-5 on the relative residual, same iteration in both packages) are
held to 1e-4 of scale: the two recurrences see those rounding differences
at every iteration.  bf16 payload solves are held to the same 1e-4 against
the JAX bf16 solve on its pallas-interpret backend: there, as in the port's
kernel, the payload is rounded to bf16 once; XLA's CPU path keeps the bf16
product loads·f in float32 inside its fused loop (excess precision), which
differs from both by a bf16 rounding (≈1e-3 of scale after the solve).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import solvers as jsolvers  # noqa: E402
from repro.core import features as jfeat  # noqa: E402
from repro.core import linops as jlin  # noqa: E402
from repro.core import modulation as jmod  # noqa: E402
from repro.core import walks as jwalks  # noqa: E402
from repro.gp import mll as jmll  # noqa: E402
from repro.gp import posterior as jpost  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch import interop, solvers  # noqa: E402
from repro_torch.core import features as tfeat  # noqa: E402
from repro_torch.core import linops as tlin  # noqa: E402
from repro_torch.core import modulation as tmod  # noqa: E402
from repro_torch.core import walks as twalks  # noqa: E402
from repro_torch.gp import mll as tmll  # noqa: E402
from repro_torch.gp import posterior as tpost  # noqa: E402

CPU = "cpu"
SEED = 1214163296
CFG = dict(n_walkers=8, p_halt=0.2, l_max=4)
OP_TOL = 1e-5
CG_TOL = 1e-4


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


class Problem:
    """grid2d(10, 10), a trace from the uint32 seed, diffusion f, 30 obs."""

    def __init__(self):
        self.jg = jgen.grid2d(10, 10)
        self.n = 100
        self.tg = interop.graph_from_numpy(self.jg.neighbors, self.jg.weights,
                                           self.jg.deg, device=CPU)
        self.ttr = twalks.sample_walks(self.tg, SEED, **CFG)
        self.jtr = jwalks.WalkTrace(jnp.asarray(self.ttr.cols.numpy()),
                                    jnp.asarray(self.ttr.loads.numpy()),
                                    jnp.asarray(self.ttr.lens.numpy()))
        jm = jmod.diffusion(l_max=CFG["l_max"], init_beta=1.7)
        self.jparams = jmll.init_hyperparams(jm, jax.random.PRNGKey(0), 0.2)
        self.jf = jm(self.jparams["mod"])
        self.tparams = interop.params_from_numpy(self.jparams, device=CPU)
        self.tf = tmod.diffusion(CFG["l_max"])(self.tparams["mod"])
        rng = np.random.default_rng(0)
        self.train = np.sort(rng.choice(self.n, 30, replace=False)).astype(np.int32)
        self.y = rng.standard_normal(30).astype(np.float32)
        self.v = rng.standard_normal((self.n, 3)).astype(np.float32)
        self.ttrain = torch.from_numpy(self.train)
        self.jtrain = jnp.asarray(self.train)


@pytest.fixture(scope="module")
def p():
    return Problem()


def test_trace_matches_jax_sample_walks(p):
    """The port's trace is the JAX package's for the same uint32 seed."""
    j = jwalks._sample(p.jg, jnp.arange(p.n, dtype=jnp.int32), jnp.uint32(SEED),
                       cfg=jwalks.WalkConfig(**CFG), spmv_backend="xla")
    np.testing.assert_array_equal(p.ttr.cols.numpy(), np.asarray(j.cols))
    np.testing.assert_array_equal(p.ttr.lens.numpy(), np.asarray(j.lens))
    np.testing.assert_array_max_ulp(p.ttr.loads.numpy(), np.asarray(j.loads), 1)


@pytest.mark.parametrize("name,kw", [
    ("diffusion", dict(init_beta=0.7)),
    ("matern", dict(nu=2.5, init_kappa=1.3)),
    ("learnable", {}),
])
def test_modulations_match_jax(name, kw):
    jm = jmod.REGISTRY[name](6, **kw)
    tm = tmod.REGISTRY[name](6, **kw)
    params = jm.init(jax.random.PRNGKey(2))
    close(tm(interop.params_from_numpy(params, device=CPU)), jm(params), 1e-6)
    tparams = tm.init(torch.Generator().manual_seed(0), device=CPU)
    assert set(tparams) == set(params)
    assert tm(tparams).shape == (7,) and tm.l_max == 6


def test_hyperparams_match_jax(p):
    close(tmll.noise_var(p.tparams), jmll.noise_var(p.jparams), 1e-7)
    t = tmll.init_hyperparams(tmod.diffusion(3), init_noise=0.2, device=CPU)
    close(t["log_sigma_n"], p.jparams["log_sigma_n"], 1e-7)


def test_feature_products_match_jax(p):
    jt, tt, jf, tf = p.jtr, p.ttr, p.jf, p.tf
    close(tfeat.feature_values(tt, tf), jfeat.feature_values(jt, jf), 1e-7)
    u = p.v
    close(tfeat.phi_matvec(tt, tf, torch.from_numpy(u)),
          jfeat.phi_matvec(jt, jf, jnp.asarray(u)), OP_TOL)
    close(tfeat.phi_t_matvec(tt, tf, torch.from_numpy(u[:, 0]), p.n),
          jfeat.phi_t_matvec(jt, jf, jnp.asarray(u[:, 0]), p.n), OP_TOL)
    close(tfeat.khat_matvec(tt, tf, torch.from_numpy(u)),
          jfeat.khat_matvec(jt, jf, jnp.asarray(u)), OP_TOL)
    tx, jxt = tfeat.take_rows(tt, p.ttrain), jfeat.take_rows(jt, p.jtrain)
    close(tfeat.khat_cross_matvec(tt, tx, tf, torch.from_numpy(u[:30]), p.n),
          jfeat.khat_cross_matvec(jt, jxt, jf, jnp.asarray(u[:30]), p.n), OP_TOL)
    close(tfeat.materialize_khat(tx, tf, p.n), jfeat.materialize_khat(jxt, jf, p.n),
          OP_TOL)
    close(tfeat.khat_diag_approx(tt, tf), jfeat.khat_diag_approx(jt, jf), OP_TOL)
    close(tfeat.khat_diag_exact(tt, tf), jfeat.khat_diag_exact(jt, jf), OP_TOL)


@pytest.mark.parametrize("chunk", [33, 100, 128])
def test_chunked_drivers_match_jax(p, chunk):
    cfg_j, cfg_t = jwalks.WalkConfig(**CFG), twalks.WalkConfig(**CFG)
    u, seed = p.v, jnp.uint32(SEED)
    close(tfeat.phi_matvec_chunked(p.tg, p.tf, torch.from_numpy(u), SEED,
                                   cfg=cfg_t, chunk=chunk),
          jfeat.phi_matvec_chunked(p.jg, p.jf, jnp.asarray(u), seed,
                                   cfg=cfg_j, chunk=chunk), OP_TOL)
    close(tfeat.phi_t_matvec_chunked(p.tg, p.tf, torch.from_numpy(u[:, 1]), SEED,
                                     cfg=cfg_t, chunk=chunk),
          jfeat.phi_t_matvec_chunked(p.jg, p.jf, jnp.asarray(u[:, 1]), seed,
                                     cfg=cfg_j, chunk=chunk), OP_TOL)
    close(tfeat.khat_diag_approx_chunked(p.tg, p.tf, SEED, cfg=cfg_t, chunk=chunk,
                                         row_start=10, n_rows=57),
          jfeat.khat_diag_approx_chunked(p.jg, p.jf, seed, cfg=cfg_j, chunk=chunk,
                                         row_start=10, n_rows=57), OP_TOL)


def test_linops_match_jax(p):
    u = p.v
    tphi, jphi = tlin.phi(p.ttr, p.tf), jlin.phi(p.jtr, p.jf)
    close(tphi(torch.from_numpy(u)), jphi(jnp.asarray(u)), OP_TOL)
    close(tphi.rmatvec(torch.from_numpy(u)), jphi.rmatvec(jnp.asarray(u)), OP_TOL)
    close(tphi.diag_approx(), jphi.diag_approx(), OP_TOL)
    close(tphi.diag_sq(), jphi.diag_sq(), OP_TOL)
    close(tphi.dense(), jphi.dense(), OP_TOL)
    close(tphi.take_rows(p.ttrain).dense(), jphi.take_rows(p.jtrain).dense(), OP_TOL)
    # Fused (no hook) and composed (identity reduce hook) K̂ agree with JAX.
    tk, jk = tlin.khat(p.ttr, p.tf), jlin.khat(p.jtr, p.jf)
    tk_c = tlin.khat(p.ttr, p.tf, reduce=lambda x: x)
    for op in (tk, tk_c, tk.transpose()):
        close(op(torch.from_numpy(u)), jk(jnp.asarray(u)), OP_TOL)
    close(tk.dense(), jk.dense(), OP_TOL)
    # Shifted: scalar noise, per-row noise, masked sandwich.
    tx, jxt = tfeat.take_rows(p.ttr, p.ttrain), jfeat.take_rows(p.jtr, p.jtrain)
    mask = (np.arange(30) % 4 != 0).astype(np.float32)
    noise = np.linspace(0.05, 0.5, 30).astype(np.float32)
    for (tn, tm), (jn, jm) in [
        ((0.05, None), (0.05, None)),
        ((torch.from_numpy(noise), None), (jnp.asarray(noise), None)),
        ((0.05, torch.from_numpy(mask)), (0.05, jnp.asarray(mask))),
    ]:
        th = tlin.shifted(tx, p.tf, tn, p.n, mask=tm)
        jh = jlin.shifted(jxt, p.jf, jn, p.n, mask=jm)
        close(th(torch.from_numpy(u[:30])), jh(jnp.asarray(u[:30])), OP_TOL)
        close(th.diag_approx(), jh.diag_approx(), OP_TOL)
        close(th.dense(), jh.dense(), OP_TOL)
        close(th.with_matvec_dtype("bfloat16")(torch.from_numpy(u[:30])),
              jh.with_matvec_dtype("bfloat16")(jnp.asarray(u[:30])), OP_TOL)
    assert th.shape == (30, 30)


def test_chunked_operators_match_jax(p):
    cfg_j, cfg_t = jwalks.WalkConfig(**CFG), twalks.WalkConfig(**CFG)
    key = jax.random.PRNGKey(9)
    seed = int(jwalks.walk_seed(key))
    u = p.v
    tp_ = tlin.chunked_phi(p.tg, p.tf, seed, cfg_t, chunk=27)
    jp_ = jlin.chunked_phi(p.jg, p.jf, key, cfg_j, chunk=27)
    close(tp_(torch.from_numpy(u)), jp_(jnp.asarray(u)), OP_TOL)
    close(tp_.rmatvec(torch.from_numpy(u)), jp_.rmatvec(jnp.asarray(u)), OP_TOL)
    close(tp_.diag_sq(), jp_.diag_sq(), OP_TOL)
    tx = twalks.sample_walks_for_nodes(p.tg, p.ttrain, seed, **CFG)
    jxt = jwalks.sample_walks_for_nodes(p.jg, p.jtrain, key, **CFG)
    close(tlin.chunked_khat(p.tg, p.tf, seed, cfg_t, 27)(torch.from_numpy(u)),
          jlin.chunked_khat(p.jg, p.jf, key, cfg_j, 27)(jnp.asarray(u)), OP_TOL)
    close(tlin.chunked_khat_cross(p.tg, tx, p.tf, seed, cfg_t, 27)(
              torch.from_numpy(u[:30])),
          jlin.chunked_khat_cross(p.jg, jxt, p.jf, key, cfg_j, 27)(
              jnp.asarray(u[:30])), OP_TOL)
    with pytest.raises(NotImplementedError):
        tp_.dense()


@pytest.mark.parametrize("precond", ["jacobi", "none"])
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("rhs", [1, 4])
def test_solve_matches_jax(p, precond, adaptive, rhs):
    tx, jxt = tfeat.take_rows(p.ttr, p.ttrain), jfeat.take_rows(p.jtr, p.jtrain)
    b = np.random.default_rng(rhs).standard_normal((30, rhs)).astype(np.float32)
    if rhs == 1:
        b = b[:, 0]
    st_t = solvers.SolveStrategy(tol=1e-6, max_iters=40, preconditioner=precond,
                                 adaptive=adaptive)
    st_j = jsolvers.SolveStrategy(tol=1e-6, max_iters=40, preconditioner=precond,
                                  adaptive=adaptive)
    rt = solvers.solve(tmll.make_h_operator(tx, p.tf, 0.05, p.n),
                       torch.from_numpy(b), st_t)
    rj = jsolvers.solve(jmll.make_h_operator(jxt, p.jf, 0.05, p.n),
                        jnp.asarray(b), st_j)
    close(rt.x, rj.x, CG_TOL)
    assert abs(rt.iters - int(rj.iters)) <= 1
    assert bool(rt.converged.all()) == bool(jnp.all(rj.converged))
    # Against the dense solve as well.
    h = tlin.shifted(tx, p.tf, 0.05, p.n).dense().double()
    close(rt.x, np.linalg.solve(h.numpy(), b.astype(np.float64)), CG_TOL)


def test_solve_bf16_payload_and_warm_start_match_jax(p):
    tx, jxt = tfeat.take_rows(p.ttr, p.ttrain), jfeat.take_rows(p.jtr, p.jtrain)
    b = np.random.default_rng(5).standard_normal((30, 2)).astype(np.float32)
    x0 = np.full((30,), 0.1, np.float32)
    kw = dict(tol=1e-6, max_iters=40, matvec_dtype="bfloat16", warm_start=True)
    rt = solvers.solve(tmll.make_h_matvec(tx, p.tf, 0.05, p.n), torch.from_numpy(b),
                       solvers.SolveStrategy(**kw), x0=torch.from_numpy(x0))
    with jdispatch.use_backend("pallas-interpret"):
        rj = jsolvers.solve(jmll.make_h_matvec(jxt, p.jf, 0.05, p.n),
                            jnp.asarray(b), jsolvers.SolveStrategy(**kw),
                            x0=jnp.asarray(x0))
    close(rt.x, rj.x, CG_TOL)
    assert bool(rt.converged.all())
    # A bare callable gets its operand cast instead of its payload.
    h = tmll.make_h_operator(tx, p.tf, 0.05, p.n)
    rc = solvers.solve(lambda v: h(v), torch.from_numpy(b),
                       solvers.SolveStrategy(tol=1e-6, max_iters=60,
                                             matvec_dtype="bfloat16"))
    assert bool(torch.isfinite(rc.x).all()) and rc.x.dtype == torch.float32


def test_cg_loops_match_jax_directly(p):
    """cg_solve / cg_solve_fixed with a bare matvec and a Jacobi diagonal."""
    from repro.solvers import cg as jcg

    tx, jxt = tfeat.take_rows(p.ttr, p.ttrain), jfeat.take_rows(p.jtr, p.jtrain)
    th, jh = tmll.make_h_operator(tx, p.tf, 0.1, p.n), jmll.make_h_operator(jxt, p.jf, 0.1, p.n)
    b = np.random.default_rng(8).standard_normal(30).astype(np.float32)
    rt = solvers.cg_solve(th, torch.from_numpy(b), tol=1e-6, max_iters=50,
                          precond_diag=th.diag_approx())
    rj = jcg.cg_solve(jh, jnp.asarray(b), tol=1e-6, max_iters=50,
                      precond_diag=jh.diag_approx())
    close(rt.x, rj.x, CG_TOL)
    ft = solvers.cg_solve_fixed(th, torch.from_numpy(b), 7)
    fj = jcg.cg_solve_fixed(jh, jnp.asarray(b), 7)
    close(ft.x, fj.x, CG_TOL)
    close(ft.resnorm, fj.resnorm, CG_TOL)
    assert ft.iters == 7


@pytest.mark.parametrize("bad", [
    dict(preconditioner="nystrom"), dict(preconditioner="auto")])
def test_later_slice_features_raise(p, bad):
    tx = tfeat.take_rows(p.ttr, p.ttrain)
    h = tmll.make_h_operator(tx, p.tf, 0.05, p.n)
    with pytest.raises(NotImplementedError, match="slice"):
        solvers.solve(h, torch.ones(30), solvers.SolveStrategy(**bad))
    with pytest.raises(NotImplementedError, match="slice"):
        solvers.solve(h, torch.ones(30), escalate=True)
    with pytest.raises(ValueError):
        solvers.SolveStrategy(preconditioner="ilu")


def test_posterior_mean_matches_jax(p):
    got = tpost.posterior_mean(p.ttr, p.ttrain, p.tf, 0.05, torch.from_numpy(p.y))
    want = jpost.posterior_mean(p.jtr, p.jtrain, p.jf, 0.05, jnp.asarray(p.y))
    close(got, want, CG_TOL)
    mask = (np.arange(30) % 5 != 0).astype(np.float32)
    got = tpost.posterior_mean(p.ttr, p.ttrain, p.tf, 0.05, torch.from_numpy(p.y),
                               obs_mask=torch.from_numpy(mask), cg_iters=200)
    want = jpost.posterior_mean(p.jtr, p.jtrain, p.jf, 0.05, jnp.asarray(p.y),
                                obs_mask=jnp.asarray(mask), cg_iters=200)
    close(got, want, CG_TOL)


def _jax_noise(key, n, t, s):
    """The w / unit eps JAX's pathwise samplers draw from ``key``."""
    k_w, k_eps = jax.random.split(key)
    w = np.array(jax.random.normal(k_w, (n, s), dtype=jnp.float32))
    eps = np.array(jax.random.normal(k_eps, (t, s)))
    return torch.from_numpy(w), torch.from_numpy(eps)


def test_pathwise_samples_match_jax(p):
    key = jax.random.PRNGKey(3)
    want, jit_, jconv = jpost.pathwise_samples(
        p.jtr, p.jtrain, p.jf, 0.05, jnp.asarray(p.y), key, n_samples=6,
        return_diagnostics=True)
    w, eps = _jax_noise(key, p.n, 30, 6)
    got, it, conv = tpost._pathwise_samples(
        p.ttr, p.ttrain, p.tf, 0.05, torch.from_numpy(p.y), w, eps, None,
        solvers.POSTERIOR_DEFAULT)
    close(got, want, CG_TOL)
    assert conv and bool(jconv) and abs(it - int(jit_)) <= 1
    # The public entry point: generator-drawn noise, diagnostics, shapes.
    s, it2, conv2 = tpost.pathwise_samples(
        p.ttr, p.ttrain, p.tf, 0.05, torch.from_numpy(p.y),
        torch.Generator().manual_seed(0), n_samples=5, return_diagnostics=True)
    assert s.shape == (p.n, 5) and conv2 and it2 > 0


def test_pathwise_chunked_matches_jax_and_monolithic(p):
    key, walk_key = jax.random.PRNGKey(4), jax.random.PRNGKey(5)
    seed = int(jwalks.walk_seed(walk_key))
    cfg_j, cfg_t = jwalks.WalkConfig(**CFG), twalks.WalkConfig(**CFG)
    want = jpost.pathwise_samples_chunked(
        p.jg, p.jtrain, p.jf, 0.05, jnp.asarray(p.y), key, walk_key, cfg_j,
        chunk=33, n_samples=3)
    w, eps = _jax_noise(key, p.n, 30, 3)
    got, _, conv = tpost._pathwise_samples_chunked(
        p.tg, p.ttrain, p.tf, 0.05, torch.from_numpy(p.y), w, eps, seed, cfg_t,
        33, None, solvers.POSTERIOR_DEFAULT)
    close(got, want, CG_TOL)
    assert conv
    # chunked == monolithic for the same walk seed and the same generator.
    tr = twalks.sample_walks(p.tg, seed, **CFG)
    y = torch.from_numpy(p.y)
    mono = tpost.pathwise_samples(tr, p.ttrain, p.tf, 0.05, y,
                                  torch.Generator().manual_seed(1), n_samples=3)
    chk = tpost.pathwise_samples_chunked(p.tg, p.ttrain, p.tf, 0.05, y,
                                         torch.Generator().manual_seed(1), seed,
                                         cfg_t, chunk=33, n_samples=3)
    close(chk, mono.numpy(), CG_TOL)


def test_predictive_metrics_match_jax(p):
    rng = np.random.default_rng(2)
    s = rng.standard_normal((40, 7)).astype(np.float32)
    y = rng.standard_normal(40).astype(np.float32)
    tm, tv = tpost.predictive_moments_from_samples(torch.from_numpy(s))
    jm_, jv = jpost.predictive_moments_from_samples(jnp.asarray(s))
    close(tm, jm_, 1e-6)
    close(tv, jv, 1e-6)
    close(tpost.rmse(torch.from_numpy(y), tm), jpost.rmse(jnp.asarray(y), jm_), 1e-6)
    close(tpost.gaussian_nlpd(torch.from_numpy(y), tm, tv),
          jpost.gaussian_nlpd(jnp.asarray(y), jm_, jv), 1e-5)


def test_interop_round_trips(p):
    g = p.jg
    tg = interop.graph_from_numpy(g.neighbors, g.weights, g.deg, device=CPU)
    assert tg.n_nodes == 100 and tg.max_deg == g.max_deg
    for a, b in ((tg.neighbors, g.neighbors), (tg.weights, g.weights), (tg.deg, g.deg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tr = interop.trace_from_numpy(p.jtr.cols, p.jtr.loads, p.jtr.lens, device=CPU)
    assert tr.slots == 40 and tr.cols.dtype == torch.int32
    for field in ("cols", "loads", "lens"):
        np.testing.assert_array_equal(getattr(tr, field).numpy(),
                                      np.asarray(getattr(p.jtr, field)))
    pr = interop.params_from_numpy(p.jparams, device=CPU)
    assert set(pr) == {"mod", "log_sigma_n"}
    assert set(pr["mod"]) == {"log_beta", "log_sigma_f"}
    np.testing.assert_array_equal(pr["mod"]["log_beta"].numpy(),
                                  np.asarray(p.jparams["mod"]["log_beta"]))
    # Writable copies: the JAX arrays behind them stay untouched.
    pr["log_sigma_n"] += 1.0
    assert float(p.jparams["log_sigma_n"]) == pytest.approx(np.log(0.2))
