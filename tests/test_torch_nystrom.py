"""PyTorch port, the Nyström/SLQ solver stack against the JAX package: the
recorded CG recurrence, SLQ log-determinants and the exact LML, the pivoted
Cholesky and the preconditioner it builds, the spectral probe and its rank
choice, and solves, posteriors and fit steps under ``"nystrom"``.

Both packages get the same walk trace (sampled by the port with one uint32
seed and handed across), the same f, noise and right-hand sides, and the
same Rademacher probes: where the JAX function draws them from a key, the
port's module-level ``rademacher`` is monkeypatched to return JAX's array.
The JAX side runs its "xla" path (its woodbury kernel, in interpret mode,
is held against the port in test_torch_woodbury.py).

Three paths are held against the port's own ``select_rank`` and
``check_operator`` rather than a live JAX call, because the installed jax
lacks ``jax.core.trace_state_clean``, which the JAX ``resolve_strategy``
calls: ``resolve_strategy`` itself, the fit's ``"auto"`` (resolved once per
fit) and each BO loop's ``"auto"`` (resolved once per run).

Tolerances, relative to the result's scale: identical coefficient arrays
through the tridiagonal and its eigensolve: 1e-5.  Anything through CG (the
recorded α/β, SLQ, the exact LML, solves, posteriors, the pivoted factor
and the preconditioner built from it, the probe's Ritz values and weights):
1e-4, as every CG iteration sees the two packages' summation orders.  Five
Adam steps compound that: parameters to 1e-3 and CG counts within ±1.
Pivots and ranks are integers: exact, on inputs whose every greedy argmax
wins by more than 1e-4 (checked from the JAX side).  On the clustered block
the recorded α of the two packages agree to 1e-5 for 19 iterations, then
their rounding differences grow tenfold per iteration (4e-3 at 21, 0.16 at
22, with the residual still at 1e-2): its SLQ and probe passes compared
here stop at 20 and 16 iterations.  The rank choice, an argmin over a
coarse cost model, is compared at the probe's default 24.
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
from repro.gp import variational as jvar  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro.solvers import nystrom as jnys  # noqa: E402
from repro.solvers import slq as jslq  # noqa: E402
from repro_torch import interop, solvers  # noqa: E402
from repro_torch.bo import thompson as tthompson  # noqa: E402
from repro_torch.core import features as tfeat  # noqa: E402
from repro_torch.core import linops as tlin  # noqa: E402
from repro_torch.core import modulation as tmod  # noqa: E402
from repro_torch.core import walks as twalks  # noqa: E402
from repro_torch.examples import solver_strategies  # noqa: E402
from repro_torch.gp import mll as tmll  # noqa: E402
from repro_torch.gp import posterior as tpost  # noqa: E402
from repro_torch.gp import variational as tvar  # noqa: E402
from repro_torch.graphs import generators as tgen  # noqa: E402
from repro_torch.graphs import signals as tsig  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.solvers import nystrom as tnys  # noqa: E402
from repro_torch.solvers import slq as tslq  # noqa: E402

CPU = "cpu"
SEED = 1214163296
N, T = 500, 80
CFG = dict(n_walkers=6, p_halt=0.15, l_max=5)     # K = 36
CG_TOL = 1e-4
TIGHT = dict(tol=1e-6, max_iters=500)
# (β, σ_f, σ²): the clustered block where JAX's select_rank picks a rank,
# and a better-conditioned one where it picks 0 (Jacobi).
CLUSTERED = (3.0, 1.0, 1e-2)
MILD = (1.0, 1.0, 0.5)


def close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


class Problem:
    """ring(500), T = 80 contiguous training nodes (correlated rows), the
    full trace and the training rows from one uint32 seed."""

    def __init__(self):
        self.tg = tgen.ring(N, k=3, device=CPU)
        self.ttr_full = twalks.sample_walks(self.tg, SEED, **CFG)
        self.train = np.arange(T, dtype=np.int32)
        self.ttrain = torch.from_numpy(self.train)
        self.jtrain = jnp.asarray(self.train)
        self.ttr = tfeat.take_rows(self.ttr_full, self.ttrain)
        self.jtr_full = self.to_jax(self.ttr_full)
        self.jtr = self.to_jax(self.ttr)
        rng = np.random.default_rng(0)
        self.y = rng.standard_normal(T).astype(np.float32)
        self.b = rng.standard_normal((T, 3)).astype(np.float32)
        self.mask = (np.arange(T) % 7 != 3).astype(np.float32)

    @staticmethod
    def to_jax(tr):
        return jwalks.WalkTrace(*(jnp.asarray(a.numpy()) for a in
                                  (tr.cols, tr.loads, tr.lens)))

    def f(self, beta, sigma_f):
        """The same f in both packages (JAX computes it, the port is handed it)."""
        jf = jmod.diffusion(CFG["l_max"])({"log_beta": jnp.log(beta),
                                          "log_sigma_f": jnp.log(sigma_f)})
        return torch.from_numpy(np.array(jf)), jf

    def ops(self, point=CLUSTERED, noise="scalar"):
        """(port H, JAX H) with scalar noise, a noise vector, or the masked
        sandwich M K̂ M + D with 1e6 noise on the dead slots."""
        beta, sigma_f, s2 = point
        tf, jf = self.f(beta, sigma_f)
        if noise == "scalar":
            return (tlin.shifted(self.ttr, tf, s2, N),
                    jlin.shifted(self.jtr, jf, jnp.asarray(s2), N))
        if noise == "vector":
            d = (s2 * (1.0 + np.arange(T) % 5)).astype(np.float32)
            return (tlin.shifted(self.ttr, tf, torch.from_numpy(d), N),
                    jlin.shifted(self.jtr, jf, jnp.asarray(d), N))
        d = np.where(self.mask > 0, s2, 1e6).astype(np.float32)
        return (tlin.shifted(self.ttr, tf, torch.from_numpy(d), N,
                             mask=torch.from_numpy(self.mask)),
                jlin.shifted(self.jtr, jf, jnp.asarray(d), N,
                             mask=jnp.asarray(self.mask)))


@pytest.fixture(scope="module")
def p():
    return Problem()


def jax_probes(monkeypatch, module, key):
    """Make ``module.rademacher`` return the probes JAX draws from ``key``."""
    def draw(generator, shape, dtype=torch.float32, device=None):
        return torch.from_numpy(np.array(jslq.rademacher(key, tuple(shape))))

    monkeypatch.setattr(module, "rademacher", draw)


def test_cg_fixed_with_coeffs_matches_jax(p):
    th, jh = p.ops()
    b = np.concatenate([p.b, np.zeros((T, 1), np.float32)], axis=1)  # a dead column
    tres, tco = solvers.cg_solve_fixed(th, torch.from_numpy(b), 20, with_coeffs=True)
    jres, jco = jsolvers.cg_solve_fixed(jh, jnp.asarray(b), 20, with_coeffs=True)
    for name in ("alphas", "betas", "bnorm2"):
        close(getattr(tco, name), getattr(jco, name), CG_TOL)
    np.testing.assert_array_equal(tco.valid.numpy(), np.asarray(jco.valid))
    assert not tco.valid[:, 3].any() and tco.valid[:, :3].all()
    close(tres.x, jres.x, CG_TOL)
    assert tco.alphas.shape == (20, 4)
    # Without the flag the result is the CGResult alone.
    assert isinstance(solvers.cg_solve_fixed(th, torch.from_numpy(b), 3),
                      solvers.CGResult)


def test_tridiag_and_logdet_from_identical_coeffs_match_jax():
    rng = np.random.default_rng(7)
    m, r = 12, 5
    alphas = rng.uniform(0.2, 2.0, (m, r)).astype(np.float32)
    betas = rng.uniform(0.0, 0.8, (m, r)).astype(np.float32)
    valid = np.ones((m, r), bool)
    valid[9:, 1] = False          # a column that converged after 9 iterations
    valid[:, 4] = False           # and one that never ran
    bnorm2 = rng.uniform(10.0, 30.0, r).astype(np.float32)
    tco = solvers.LanczosCoeffs(*(torch.from_numpy(a) for a in (alphas, betas, valid, bnorm2)))
    jco = jsolvers.LanczosCoeffs(*(jnp.asarray(a) for a in (alphas, betas, valid, bnorm2)))
    close(solvers.tridiag_from_coeffs(tco), jsolvers.tridiag_from_coeffs(jco), 1e-5)
    close(solvers.logdet_from_coeffs(tco), jsolvers.logdet_from_coeffs(jco), 1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_slq_logdet_matches_jax(p, monkeypatch, masked):
    """Plain H, and the masked sandwich exact_lml builds (unit noise on the
    dead slots: with 1e6 noise there SLQ in float32 misses the dense
    log-det in both packages)."""
    th, jh = p.ops()
    if masked:
        tf, jf = p.f(*CLUSTERED[:2])
        s2 = CLUSTERED[2]
        th = tmll._lml_operator(p.ttr, tf, s2, N, torch.from_numpy(p.mask))
        jh = jlin.ShiftedOperator(jlin.khat(p.jtr, jf, N),
                                  jnp.where(jnp.asarray(p.mask) > 0, s2, 1.0),
                                  mask=jnp.asarray(p.mask))
    key = jax.random.PRNGKey(3)
    want = jsolvers.slq_logdet(jh, T, key, n_probes=8, n_iters=20)
    jax_probes(monkeypatch, tslq, key)
    got = solvers.slq_logdet(th, T, torch.Generator().manual_seed(0),
                             n_probes=8, n_iters=20)
    close(got, want, CG_TOL)
    # And it estimates the dense log-det (a few percent at 8 probes).
    dense = np.linalg.slogdet(th.dense().double().numpy())[1]
    assert abs(float(got) - dense) < 0.1 * abs(dense)


@pytest.mark.parametrize("masked,pc", [(False, "none"), (True, "nystrom")])
def test_exact_lml_matches_jax(p, monkeypatch, masked, pc):
    beta, sigma_f, s2 = CLUSTERED
    tf, jf = p.f(beta, sigma_f)
    key = jax.random.PRNGKey(11)
    mask = p.mask if masked else None
    strat = dict(**TIGHT, preconditioner=pc, precond_rank=16)
    want = jmll.exact_lml(p.jtr, jf, jnp.asarray(s2), jnp.asarray(p.y), N, key,
                          strategy=jsolvers.SolveStrategy(**strat), n_probes=8,
                          slq_iters=20,
                          obs_mask=None if mask is None else jnp.asarray(mask))
    jax_probes(monkeypatch, tslq, key)
    got = tmll.exact_lml(p.ttr, tf, s2, torch.from_numpy(p.y), N,
                         torch.Generator().manual_seed(0),
                         strategy=solvers.SolveStrategy(**strat), n_probes=8,
                         slq_iters=20,
                         obs_mask=None if mask is None else torch.from_numpy(mask))
    for k in ("lml", "datafit", "logdet"):
        close(got[k], want[k], CG_TOL)
    assert got["converged"] and bool(want["converged"])


def _greedy_gaps(fmat, piv, d0):
    """From the JAX side: at every step the pivot is the argmax of the
    residual diagonal and beats the runner-up by more than 1e-4 relative."""
    d = np.asarray(d0, np.float64)
    f64 = np.asarray(fmat, np.float64)
    taken = np.zeros(d.shape, bool)
    for i, pv in enumerate(np.asarray(piv)):
        cand = np.where(taken, -np.inf, d)
        top2 = np.sort(cand)[-2:]
        assert int(np.argmax(cand)) == pv
        assert top2[1] - top2[0] > 1e-4 * abs(top2[1]), (i, top2)
        d = np.maximum(d - f64[:, i] ** 2, 0.0)
        taken[pv] = True


def test_pivoted_cholesky_and_inducing_selection_match_jax(p):
    tf, jf = p.f(*CLUSTERED[:2])
    jvals = jfeat.feature_values(p.jtr, jf)
    jd0 = jfeat.khat_diag_exact(p.jtr, jf)
    jF, jpiv = jnys._pivoted_cholesky(jvals, p.jtr.cols, jd0, 24)
    _greedy_gaps(jF, jpiv, jd0)
    tF, tpiv = tnys._pivoted_cholesky(tfeat.feature_values(p.ttr, tf), p.ttr.cols,
                                      tfeat.khat_diag_exact(p.ttr, tf), 24)
    np.testing.assert_array_equal(tpiv.numpy(), np.asarray(jpiv))
    assert tpiv.dtype == torch.int32
    close(tF, jF, CG_TOL)
    np.testing.assert_array_equal(
        tvar.init_inducing_pivoted(p.ttr, tf, 24).numpy(),
        np.asarray(jvar.init_inducing_pivoted(p.jtr, jf, 24)))
    np.testing.assert_array_equal(solvers.pivot_rows(p.ttr, tf, 24).numpy(),
                                  np.asarray(jpiv))


@pytest.mark.parametrize("noise", ["scalar", "vector", "masked"])
def test_nystrom_precond_apply_and_logdet_match_jax(p, noise):
    th, jh = p.ops(noise=noise)
    tpc = solvers.nystrom_precond(th, rank=16)
    jpc = jsolvers.nystrom_precond(jh, rank=16)
    assert tpc.rank == jpc.rank == 16
    np.testing.assert_array_equal(tpc.pivots.numpy(), np.asarray(jpc.pivots))
    close(tpc(torch.from_numpy(p.b)), jpc(jnp.asarray(p.b)), CG_TOL)
    close(tpc(torch.from_numpy(p.y)), jpc(jnp.asarray(p.y)), CG_TOL)
    close(tpc.logdet(), jpc.logdet(), CG_TOL)


@pytest.mark.parametrize("point,n_iters", [(CLUSTERED, 16), (MILD, 24)])
def test_probe_spectrum_matches_jax(p, monkeypatch, point, n_iters):
    th, jh = p.ops(point)
    key = jax.random.PRNGKey(0)
    jtheta, jw = jnys.probe_spectrum(jh, key, n_iters=n_iters)
    jax_probes(monkeypatch, tnys, key)
    ttheta, tw = solvers.probe_spectrum(th, n_iters=n_iters)
    close(ttheta, jtheta, CG_TOL)
    close(tw, jw, CG_TOL)


@pytest.mark.parametrize("point,picks_rank", [(CLUSTERED, True), (MILD, False)])
def test_select_rank_matches_jax(p, monkeypatch, point, picks_rank):
    th, jh = p.ops(point)
    key = jax.random.PRNGKey(0)
    want = jnys.select_rank(jh, key=key)
    assert (want > 0) == picks_rank
    jax_probes(monkeypatch, tnys, key)
    assert solvers.select_rank(th) == want
    costs = tnys.rank_costs(th)
    assert [r for r, _, _ in costs] == [0, 64, T, T]
    assert min(costs, key=lambda c: c[2])[0] == want


def test_spectral_quantile_matches_jnp_interp():
    """Ties in θ, zero weights (flat stretches of the cumulative weights)
    and counts below, inside and past the total weight."""
    theta = np.array([5.0, 3.0, 3.0, 2.5, 1.0, 0.5, 0.5, 0.2], np.float32)
    w = np.array([1.5, 0.0, 2.0, 0.0, 0.0, 3.0, 1.0, 0.5], np.float32)
    for r in (0, 1, 1.5, 2, 3, 3.5, 4, 6.5, 7, 8, 20):
        close(tnys._spectral_quantile(torch.from_numpy(theta), torch.from_numpy(w), r),
              jnys._spectral_quantile(jnp.asarray(theta), jnp.asarray(w), r), 1e-6)
    xp = np.array([0.0, 1.0, 1.0, 1.0, 2.0, 4.0], np.float32)
    fp = np.array([9.0, 8.0, 7.0, 6.0, 5.0, 1.0], np.float32)
    for x in (-1.0, 0.0, 0.5, 1.0, 1.5, 3.0, 4.0, 9.0):
        close(tnys._interp(torch.tensor(x), torch.from_numpy(xp), torch.from_numpy(fp)),
              jnp.interp(x, jnp.asarray(xp), jnp.asarray(fp)), 1e-6)


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("rank,cols", [(16, None), (40, 3)])
def test_solve_nystrom_matches_jax(p, adaptive, rank, cols):
    th, jh = p.ops()
    b = p.y if cols is None else p.b
    st = dict(**TIGHT, preconditioner="nystrom", precond_rank=rank,
              adaptive=adaptive)
    if not adaptive:
        st["max_iters"] = 30
    got = solvers.solve(th, torch.from_numpy(b), solvers.SolveStrategy(**st))
    want = jsolvers.solve(jh, jnp.asarray(b), jsolvers.SolveStrategy(**st))
    close(got.x, want.x, CG_TOL)
    assert got.precond_rank == int(want.precond_rank) == rank
    assert abs(got.iters - int(want.iters)) <= 1
    # Nyström cuts the iterations of this clustered block.
    jac = solvers.solve(th, torch.from_numpy(b), solvers.SolveStrategy(**TIGHT))
    if adaptive:
        assert got.iters < jac.iters and jac.precond_rank == 0


def test_posterior_under_nystrom_matches_jax(p):
    beta, sigma_f, s2 = CLUSTERED
    tf, jf = p.f(beta, sigma_f)
    st = dict(tol=1e-5, max_iters=512, preconditioner="nystrom", precond_rank=16)
    tst, jst = solvers.SolveStrategy(**st), jsolvers.SolveStrategy(**st)
    got = tpost.posterior_mean(p.ttr_full, p.ttrain, tf, s2, torch.from_numpy(p.y),
                               strategy=tst)
    want = jpost.posterior_mean(p.jtr_full, p.jtrain, jf, s2, jnp.asarray(p.y),
                                strategy=jst)
    close(got, want, CG_TOL)
    key = jax.random.PRNGKey(3)
    want, jit_, jconv = jpost.pathwise_samples(
        p.jtr_full, p.jtrain, jf, s2, jnp.asarray(p.y), key, n_samples=4,
        strategy=jst, return_diagnostics=True)
    k_w, k_eps = jax.random.split(key)
    w = torch.from_numpy(np.array(jax.random.normal(k_w, (N, 4), dtype=jnp.float32)))
    eps = torch.from_numpy(np.array(jax.random.normal(k_eps, (T, 4))))
    got, it, conv = tpost._pathwise_samples(
        p.ttr_full, p.ttrain, tf, s2, torch.from_numpy(p.y), w, eps, None, tst)
    close(got, want, CG_TOL)
    assert conv and bool(jconv) and abs(it - int(jit_)) <= 1


def test_fit_steps_under_nystrom_match_jax(p):
    """One warm-started 5-step chunk under "nystrom" (the preconditioner
    rebuilt at every step): JAX's _fit_chunk on a key, the port's on the
    probes JAX draws from that key."""
    n_probes, steps = 6, 5
    key = jax.random.PRNGKey(21)
    jm = jmod.diffusion(l_max=CFG["l_max"], init_beta=2.0)
    tm = tmod.diffusion(CFG["l_max"], init_beta=2.0)
    jparams = jmll.init_hyperparams(jm, jax.random.PRNGKey(0), 0.3)
    strat = jsolvers.MLL_DEFAULT.with_(preconditioner="nystrom", precond_rank=16)
    jopt = jadam.AdamW(lr=0.05)
    v0 = np.zeros((T, 1 + n_probes), np.float32)
    jp, _, _, jtr = jmll._fit_chunk(
        jparams, jopt.init(jparams), key, p.jtr, jnp.asarray(p.y),
        jnp.asarray(p.mask), jnp.asarray(v0), mod=jm, opt=jopt, n_nodes=N,
        n_probes=n_probes, strategy=strat, chunk=steps, spmv_backend="xla")
    probes = np.array(jsolvers.rademacher(key, (T, n_probes), jnp.float32))
    topt = tadam.AdamW(lr=0.05)
    tparams = interop.params_from_numpy(jparams, device=CPU)
    tp, _, _, ttr = tmll._fit_chunk(
        tparams, topt.init(tparams), None, p.ttr, torch.from_numpy(p.y),
        torch.from_numpy(p.mask), torch.from_numpy(v0), mod=tm, opt=topt,
        n_nodes=N, n_probes=n_probes,
        strategy=solvers.MLL_DEFAULT.with_(preconditioner="nystrom", precond_rank=16),
        chunk=steps, probes=torch.from_numpy(probes))
    for k in ("log_beta", "log_sigma_f"):
        close(tp["mod"][k], jp["mod"][k], 1e-3)
    close(tp["log_sigma_n"], jp["log_sigma_n"], 1e-3)
    j_iters, j_conv = np.asarray(jtr[3]), np.asarray(jtr[4])
    for i in range(steps):
        assert abs(int(ttr[3][i]) - int(j_iters[i])) <= 1, (ttr[3], j_iters)
        assert bool(ttr[4][i]) and bool(j_conv[i])


# --------------------------------------------------------------------------
# "auto" against the port's own rank rule (see the module docstring).
# --------------------------------------------------------------------------


@pytest.mark.parametrize("point", [CLUSTERED, MILD])
def test_resolve_strategy_follows_select_rank_and_check_operator(p, point):
    th, _ = p.ops(point)
    auto = solvers.SolveStrategy(**TIGHT, preconditioner="auto")
    rank = solvers.select_rank(th)
    got = solvers.resolve_strategy(th, auto)
    if rank == 0:
        assert got == auto.with_(preconditioner="jacobi")
    else:
        assert got == auto.with_(preconditioner="nystrom", precond_rank=rank)
    res = solvers.solve(th, torch.from_numpy(p.y), auto)
    assert res.precond_rank == rank and bool(res.converged.all())
    # A concrete strategy passes through untouched.
    jac = auto.with_(preconditioner="jacobi")
    assert solvers.resolve_strategy(th, jac) is jac
    # Operators that can't serve pivot rows fall back to Jacobi; building a
    # Nyström preconditioner on them raises.
    tf, _ = p.f(*point[:2])
    sharded = tlin.ShiftedOperator(tlin.khat(p.ttr, tf, N, reduce=lambda u: u), point[2])
    chunked = tlin.ShiftedOperator(
        tlin.chunked_khat(p.tg, tf, SEED, twalks.WalkConfig(**CFG), 64), point[2])
    for h in (sharded, chunked, lambda v: th(v)):
        assert tnys.check_operator(h) is not None
        assert solvers.resolve_strategy(h, auto) == jac
        with pytest.raises(ValueError, match="nystrom"):
            solvers.nystrom_precond(h)


def _count_probes(monkeypatch):
    calls = []
    real = tnys.probe_spectrum

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tnys, "probe_spectrum", counted)
    return calls


def test_fit_auto_resolves_once_per_fit(p, monkeypatch):
    calls = _count_probes(monkeypatch)
    seen = []
    real_solve = solvers.solve

    def solve(h, b, strategy, **kw):
        seen.append(strategy)
        return real_solve(h, b, strategy, **kw)

    monkeypatch.setattr(solvers, "solve", solve)
    tm = tmod.diffusion(CFG["l_max"], init_beta=3.0)
    res = tmll.fit_hyperparams(
        p.ttr, tm, torch.from_numpy(p.y), N, torch.Generator().manual_seed(0),
        steps=4, chunk=2, init_noise=0.1,
        strategy=solvers.MLL_DEFAULT.with_(preconditioner="auto"))
    assert len(calls) == 1
    assert len(seen) == 4 and len(set(seen)) == 1
    assert seen[0].preconditioner in ("nystrom", "jacobi")
    assert all(h["cg_converged"] for h in res.history)


@pytest.mark.parametrize("engine", ["refit", "incremental"])
def test_bo_loops_resolve_auto_once_per_run(monkeypatch, engine):
    calls = _count_probes(monkeypatch)
    n = 300
    g = tgen.ring(n, k=3, device=CPU)
    truth = tsig.smooth_periodic_ring(n, seed=1)
    rng = np.random.default_rng(0)

    def objective(idx):
        return truth[np.asarray(idx)] + 0.05 * rng.standard_normal(len(idx))

    cfg = twalks.WalkConfig(6, 0.2, 3)
    kw = dict(n_init=12, n_steps=3, refit_every=1, refit_steps=2,
              fit_strategy=solvers.MLL_DEFAULT.with_(preconditioner="auto"))
    if engine == "refit":
        st = tthompson.thompson_sampling(
            twalks.sample_walks(g, 77, cfg.n_walkers, cfg.p_halt, cfg.l_max),
            tmod.diffusion(3), objective, 5, **kw)
    else:
        st = tthompson.thompson_sampling_incremental(
            g, cfg, tmod.diffusion(3), objective, 5, n_candidates=64, **kw)
    assert st.iteration == 3 and len(np.unique(st.x_obs)) == 12 + 3
    assert len(calls) == 1     # three refit rounds, one probe


def test_solver_strategies_example_runs_on_cpu(capsys):
    assert solver_strategies.main(["--nodes", "2000", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "SOLVER_SMOKE_OK" in out and "rank=" in out
