"""PyTorch port, hyperparameter fit: AdamW, the LML surrogate and its
gradients through the kernels' autograd Functions, and the warm-started
Adam chunk, against the JAX package on the same inputs.

Both packages get the same walk trace (sampled with one uint32 seed), the
same parameters and the same Rademacher probes (JAX draws them; the port
is handed the array).  JAX runs its "xla" path.

Tolerances: the AdamW update is elementwise float32 in the same order:
1e-6.  The surrogate passes through a CG solve at tol 1e-6 whose iterates
see the two packages' different summation orders: loss, aux and gradients
to 1e-4 of scale.  Five Adam steps compound that: parameters to 1e-3
relative, and each step's CG iteration count within ±1.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import solvers as jsolvers  # noqa: E402
from repro.core import modulation as jmod  # noqa: E402
from repro.core import walks as jwalks  # noqa: E402
from repro.gp import mll as jmll  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro_torch import interop, solvers  # noqa: E402
from repro_torch.core import features as tfeat  # noqa: E402
from repro_torch.core import modulation as tmod  # noqa: E402
from repro_torch.core import walks as twalks  # noqa: E402
from repro_torch.gp import mll as tmll  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402

CPU = "cpu"
SEED = 1214163296
CFG = dict(n_walkers=8, p_halt=0.2, l_max=4)
N_PROBES = 6
TIGHT = dict(tol=1e-6, max_iters=256)


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def close_tree(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            close_tree(got[k], want[k], tol)
        else:
            close(got[k], want[k], tol)


class Problem:
    """grid2d(10, 10), a trace from the uint32 seed, 30 observations."""

    def __init__(self):
        jg = jgen.grid2d(10, 10)
        self.n = 100
        tg = interop.graph_from_numpy(jg.neighbors, jg.weights, jg.deg, device=CPU)
        rng = np.random.default_rng(0)
        self.train = np.sort(rng.choice(self.n, 30, replace=False)).astype(np.int32)
        tr = twalks.sample_walks(tg, SEED, **CFG)
        self.ttr = tfeat.take_rows(tr, torch.from_numpy(self.train))
        self.jtr = jwalks.WalkTrace(*(jnp.asarray(a.numpy()) for a in
                                      (self.ttr.cols, self.ttr.loads, self.ttr.lens)))
        self.jm = jmod.diffusion(l_max=CFG["l_max"], init_beta=1.7)
        self.tm = tmod.diffusion(CFG["l_max"], init_beta=1.7)
        self.jparams = jmll.init_hyperparams(self.jm, jax.random.PRNGKey(0), 0.3)
        self.y = rng.standard_normal(30).astype(np.float32)
        mask = np.ones(30, np.float32)
        mask[-7:] = 0.0          # static-shape padding slots
        self.mask = mask

    def tparams(self):
        return interop.params_from_numpy(self.jparams, device=CPU)


@pytest.fixture(scope="module")
def p():
    return Problem()


@pytest.mark.parametrize("kw", [dict(lr=0.05), dict(lr=0.1, grad_clip=0.5),
                                dict(lr=0.02, weight_decay=0.1, grad_clip=5.0)])
def test_adamw_update_matches_jax(kw):
    rng = np.random.default_rng(1)
    params = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
              "b": rng.standard_normal(5).astype(np.float32)}
    jopt, topt = jadam.AdamW(**kw), tadam.AdamW(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(4):
        g = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
             "b": rng.standard_normal(5).astype(np.float32)}
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(jax.tree.map(torch.from_numpy, g), ts, tp)
    close_tree(tp, jp, 1e-6)
    close_tree(ts.mu, js.mu, 1e-6)
    close_tree(ts.nu, js.nu, 1e-6)
    assert ts.step == int(js.step) == 4
    close(tadam.global_norm(tp), jadam.global_norm(jp), 1e-6)


def test_cosine_schedule_matches_jax():
    steps = np.arange(0, 40, 3, dtype=np.int32)
    j = jadam.cosine_schedule(0.1, 5, 30)(jnp.asarray(steps))
    t = tadam.cosine_schedule(0.1, 5, 30)(torch.from_numpy(steps))
    close(t, j, 1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_surrogate_value_aux_grads_match_jax(p, masked):
    probes = np.array(jsolvers.rademacher(jax.random.PRNGKey(4), (30, N_PROBES)))
    mask = p.mask if masked else None
    strat_j = jsolvers.SolveStrategy(**TIGHT)
    (jloss, jaux), jgrads = jax.value_and_grad(jmll.mll_surrogate_loss, has_aux=True)(
        p.jparams, jax.random.PRNGKey(9), p.jtr, p.jm, jnp.asarray(p.y), p.n,
        n_probes=N_PROBES, strategy=strat_j, probes=jnp.asarray(probes),
        obs_mask=None if mask is None else jnp.asarray(mask))
    tparams = p.tparams()
    loss, aux, grads = tmll._value_and_grad(tparams, lambda q: tmll.mll_surrogate_loss(
        q, None, p.ttr, p.tm, torch.from_numpy(p.y), p.n, n_probes=N_PROBES,
        strategy=solvers.SolveStrategy(**TIGHT), probes=torch.from_numpy(probes),
        obs_mask=None if mask is None else torch.from_numpy(mask)))
    close(loss, jloss, 1e-4)
    close_tree(grads, jgrads, 1e-4)
    for k in ("datafit", "sigma_n2", "v"):
        close(aux[k], jaux[k], 1e-4)
    assert abs(aux["cg_iters"] - int(jaux["cg_iters"])) <= 1
    assert bool(aux["cg_converged"]) and bool(jaux["cg_converged"])


def test_warm_fit_chunk_matches_jax(p):
    """One warm-started 5-step chunk: JAX's _fit_chunk on a key, the port's
    on the probes JAX draws from that key."""
    key = jax.random.PRNGKey(21)
    steps = 5
    jopt = jadam.AdamW(lr=0.05)
    jy, jmask = jnp.asarray(p.y), jnp.asarray(p.mask)
    v0 = np.random.default_rng(3).standard_normal((30, 1 + N_PROBES)).astype(np.float32)
    jp, js, jv, jtr = jmll._fit_chunk(
        p.jparams, jopt.init(p.jparams), key, p.jtr, jy, jmask, jnp.asarray(v0),
        mod=p.jm, opt=jopt, n_nodes=p.n, n_probes=N_PROBES,
        strategy=jsolvers.MLL_DEFAULT, chunk=steps, spmv_backend="xla")
    probes = np.array(jsolvers.rademacher(key, (30, N_PROBES), jnp.float32))
    topt = tadam.AdamW(lr=0.05)
    tparams = p.tparams()
    tp, ts, tv, ttr = tmll._fit_chunk(
        tparams, topt.init(tparams), None, p.ttr, torch.from_numpy(p.y),
        torch.from_numpy(p.mask), torch.from_numpy(v0), mod=p.tm, opt=topt,
        n_nodes=p.n, n_probes=N_PROBES, strategy=solvers.MLL_DEFAULT,
        chunk=steps, probes=torch.from_numpy(probes))
    close_tree(tp, jp, 1e-3)
    j_loss, j_fit, j_s2, j_iters, j_conv = (np.asarray(a) for a in jtr)
    t_loss, t_fit, t_s2, t_iters, t_conv = ttr
    assert len(t_loss) == steps
    for i in range(steps):
        assert abs(int(t_iters[i]) - int(j_iters[i])) <= 1, (i, t_iters, j_iters)
        assert bool(t_conv[i]) == bool(j_conv[i])
    close(torch.stack(t_loss), j_loss, 1e-3)
    close(torch.stack(t_s2), j_s2, 1e-3)
    close(tv, jv, 1e-3)


def test_cold_fit_chunk_draws_probes_per_step(p):
    """A cold strategy draws a fresh probe block from the generator at each
    step (a 2-step chunk equals two 1-step chunks on one generator), and
    refuses caller-supplied probes."""
    cold = solvers.MLL_DEFAULT.with_(warm_start=False)
    opt = tadam.AdamW(lr=0.05)
    kw = dict(mod=p.tm, opt=opt, n_nodes=p.n, n_probes=N_PROBES, strategy=cold)
    y, mask = torch.from_numpy(p.y), torch.from_numpy(p.mask)
    v0 = torch.zeros((30, 1 + N_PROBES))
    params = p.tparams()
    both = tmll._fit_chunk(params, opt.init(params), torch.Generator().manual_seed(5),
                           p.ttr, y, mask, v0, chunk=2, **kw)
    gen = torch.Generator().manual_seed(5)
    one = tmll._fit_chunk(params, opt.init(params), gen, p.ttr, y, mask, v0,
                          chunk=1, **kw)
    two = tmll._fit_chunk(one[0], one[1], gen, p.ttr, y, mask, v0, chunk=1, **kw)
    close_tree(both[0], two[0], 1e-6)
    again = tmll._fit_chunk(params, opt.init(params), torch.Generator().manual_seed(6),
                            p.ttr, y, mask, v0, chunk=2, **kw)
    # The surrogate's value does not depend on the probes; its gradient does.
    assert float(again[0]["log_sigma_n"]) != float(both[0]["log_sigma_n"])
    with pytest.raises(ValueError, match="warm"):
        tmll._fit_chunk(params, opt.init(params), None, p.ttr, y, mask, v0,
                        chunk=1, probes=torch.ones((30, N_PROBES)), **kw)


def test_fit_hyperparams_history_and_auto(p):
    y, mask = torch.from_numpy(p.y), torch.from_numpy(p.mask)
    res = tmll.fit_hyperparams(p.ttr, p.tm, y, p.n, torch.Generator().manual_seed(0),
                               steps=7, chunk=3, obs_mask=mask,
                               init_params=p.tparams(), strategy=solvers.MLL_DEFAULT)
    assert [h["step"] for h in res.history] == list(range(1, 8))
    assert all(h["cg_converged"] and np.isfinite(h["loss"]) for h in res.history)
    assert all(bool(torch.isfinite(x).all()) for x in tadam.tree_leaves(res.params))
    # Adam moved σ_n² from its initial 0.3² on this data.
    assert abs(res.history[-1]["sigma_n2"] - 0.09) > 1e-4
    # "auto" resolves (once, on the initial hyperparameters) and fits.
    auto = tmll.fit_hyperparams(p.ttr, p.tm, y, p.n, torch.Generator().manual_seed(0),
                                steps=2, chunk=1, obs_mask=mask,
                                init_params=p.tparams(),
                                strategy=solvers.MLL_DEFAULT.with_(preconditioner="auto"))
    assert all(h["cg_converged"] and np.isfinite(h["loss"]) for h in auto.history)


def test_rademacher_probes():
    z = solvers.rademacher(torch.Generator().manual_seed(1), (50, 4))
    assert z.shape == (50, 4) and z.dtype == torch.float32
    assert set(z.unique().tolist()) == {-1.0, 1.0}
