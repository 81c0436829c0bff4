"""PyTorch port, SVGP classification (paper §4.4, App. C.7) against the JAX
package: the dense kernel blocks, the Monte-Carlo ELBO and its gradients
given the JAX package's ε and parameters, class predictions, a fit at the
JAX test's problem, and the Cholesky-failure behaviour.

Both packages get the same walk trace (sampled by the port with the uint32
seed, handed to JAX as arrays).  Tolerances, relative to scale: kernel
blocks and the ELBO value 1e-5; ELBO gradients 1e-4 (they pass through
L_uu⁻¹ and a Cholesky's backward); predicted labels exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import features as jfeat  # noqa: E402
from repro.core import modulation as jmod  # noqa: E402
from repro.core import walks as jwalks  # noqa: E402
from repro.gp import variational as jvar  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import features as tfeat  # noqa: E402
from repro_torch.core import modulation as tmod  # noqa: E402
from repro_torch.core import walks as twalks  # noqa: E402
from repro_torch.gp import variational as tvar  # noqa: E402
from repro_torch.graphs import generators as tgen  # noqa: E402

CPU = "cpu"
TOL = 1e-5
GRAD_TOL = 1e-4
SEED = 1214163296
L_MAX = 4


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def problem():
    """test_variational.py's SBM (120 nodes, 3 classes) with a trace the
    port samples from the uint32 seed and hands to JAX."""
    jg, labels = jgen.community_sbm(120, 3, p_in=0.2, p_out=0.01, seed=0)
    tg = interop.graph_from_numpy(jg.neighbors, jg.weights, jg.deg, device=CPU)
    ttr = twalks.sample_walks(tg, SEED, n_walkers=30, p_halt=0.2, l_max=L_MAX)
    jtr = jwalks.WalkTrace(jnp.asarray(ttr.cols.numpy()),
                           jnp.asarray(ttr.loads.numpy()),
                           jnp.asarray(ttr.lens.numpy()))
    rng = np.random.default_rng(1)
    perm = rng.permutation(120)
    train, test = perm[:80].astype(np.int64), perm[80:].astype(np.int64)
    inducing = rng.choice(120, 24, replace=False).astype(np.int64)
    jm = jmod.learnable(l_max=L_MAX)
    jparams = jvar.init_svgp(jax.random.PRNGKey(2), 24, 3, jm)
    # Move the initial point off identity so every parameter's gradient is
    # exercised: a non-zero strictly-lower Σ factor and spread-out μ.
    jparams["chol_lower"] = jnp.asarray(
        0.05 * rng.standard_normal((3, 24, 24)), jnp.float32)
    jparams["mu"] = jnp.asarray(0.5 * rng.standard_normal((3, 24)), jnp.float32)
    tparams = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    return dict(jtr=jtr, ttr=ttr, labels=np.asarray(labels, np.int32),
                train=train, test=test, inducing=inducing, jm=jm,
                tm=tmod.learnable(l_max=L_MAX), jparams=jparams,
                tparams=tparams, n=120)


def test_trace_has_duplicate_columns(problem):
    """The blocks are held on a trace whose rows repeat columns, where
    Σ vals² ≠ ‖φ(i)‖²."""
    ttr = problem["ttr"]
    live = ttr.loads != 0
    cols = torch.where(live, ttr.cols, -1)
    assert bool(torch.any(tfeat.nnz_per_row(ttr) < live.sum(dim=1)))
    assert cols.shape[1] == 30 * (L_MAX + 1)


def test_kernel_blocks(problem):
    p = problem
    jf = p["jm"](p["jparams"]["mod"])
    tf = p["tm"](p["tparams"]["mod"])
    want = jvar.kernel_blocks(p["jtr"], jf, jnp.asarray(p["inducing"]),
                              jnp.asarray(p["train"]), p["n"])
    got = tvar.kernel_blocks(p["ttr"], tf, torch.from_numpy(p["inducing"]),
                             torch.from_numpy(p["train"]), p["n"])
    for g, w in zip(got, want):
        close(g, w, TOL)
    # k_xx_diag is the exact diagonal of K̂ under duplicate columns.
    exact = tfeat.khat_diag_exact(
        tfeat.take_rows(p["ttr"], torch.from_numpy(p["train"])), tf)
    close(got[2], exact.numpy(), TOL)
    approx = tfeat.khat_diag_approx(
        tfeat.take_rows(p["ttr"], torch.from_numpy(p["train"])), tf)
    assert not torch.allclose(got[2], approx, rtol=1e-3)


def test_elbo_value_and_gradients(problem):
    p = problem
    key = jax.random.PRNGKey(5)
    n_mc = 4
    eps = jax.random.normal(key, (n_mc, len(p["train"]), 3))
    args = (jnp.asarray(p["inducing"]), jnp.asarray(p["train"]),
            jnp.asarray(p["labels"][p["train"]]), p["n"], 3)

    def jloss(params):
        return jvar.elbo(params, key, p["jtr"], p["jm"], *args, n_mc=n_mc)[0]

    jval, jgrad = jax.value_and_grad(jloss)(p["jparams"])

    params = {k: (v if not isinstance(v, dict) else
                  {kk: vv.clone().requires_grad_(True) for kk, vv in v.items()})
              for k, v in p["tparams"].items()}
    for k in ("mu", "log_scale_diag", "chol_lower"):
        params[k] = params[k].clone().requires_grad_(True)
    tval, aux = tvar._elbo(
        params, torch.from_numpy(np.array(eps)), p["ttr"], p["tm"],
        torch.from_numpy(p["inducing"]), torch.from_numpy(p["train"]),
        torch.from_numpy(p["labels"][p["train"]]), p["n"])
    close(tval, jval, TOL)
    assert set(aux) == {"ll", "kl"}
    tval.backward()
    for k in ("mu", "log_scale_diag", "chol_lower"):
        close(params[k].grad, jgrad[k], GRAD_TOL)
    for k in params["mod"]:
        close(params["mod"][k].grad, jgrad["mod"][k], GRAD_TOL)


def test_elbo_draws_its_eps_from_the_generator(problem):
    p = problem
    args = (torch.from_numpy(p["inducing"]), torch.from_numpy(p["train"]),
            torch.from_numpy(p["labels"][p["train"]]), p["n"])
    got, _ = tvar.elbo(p["tparams"], torch.Generator().manual_seed(4),
                       p["ttr"], p["tm"], *args, 3, n_mc=2)
    eps = torch.randn((2, len(p["train"]), 3),
                      generator=torch.Generator().manual_seed(4))
    want, _ = tvar._elbo(p["tparams"], eps, p["ttr"], p["tm"], *args)
    assert torch.equal(got, want)


def test_predict_classes_equal(problem):
    p = problem
    want = jvar.predict_classes(p["jparams"], p["jtr"], p["jm"],
                                jnp.asarray(p["inducing"]),
                                jnp.asarray(p["test"]), p["n"])
    got = tvar.predict_classes(p["tparams"], p["ttr"], p["tm"],
                               torch.from_numpy(p["inducing"]),
                               torch.from_numpy(p["test"]), p["n"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fit_svgp_classifies_sbm_communities():
    """test_variational.py's problem and gate on the port's own draws:
    accuracy > 0.6 (chance 1/3)."""
    g, labels = tgen.community_sbm(120, 3, p_in=0.2, p_out=0.01, seed=0,
                                   device=CPU)
    tr = twalks.sample_walks(g, SEED, n_walkers=30, p_halt=0.2, l_max=L_MAX)
    mod = tmod.learnable(l_max=L_MAX)
    rng = np.random.default_rng(1)
    perm = rng.permutation(120)
    train, test = torch.from_numpy(perm[:80]), torch.from_numpy(perm[80:])
    y = torch.as_tensor(np.asarray(labels), dtype=torch.int64)
    inducing = torch.from_numpy(rng.choice(120, 24, replace=False))
    params = tvar.fit_svgp(tr, mod, inducing, train, y[train], 120, n_classes=3,
                           generator=torch.Generator().manual_seed(2),
                           steps=150, lr=0.08)
    assert set(params) == {"mod", "mu", "log_scale_diag", "chol_lower"}
    pred = tvar.predict_classes(params, tr, mod, inducing, test, 120)
    acc = float(torch.mean((pred == y[test]).float()))
    assert acc > 0.6, acc


def test_non_pd_kuu_gives_nan_not_an_exception(problem):
    """A K_uu that is not positive definite (here: a negative jitter larger
    than its spectrum) factorises to NaN, as in the JAX package, and the
    ELBO comes out NaN instead of raising."""
    p = problem
    args = (torch.from_numpy(p["inducing"]), torch.from_numpy(p["train"]),
            torch.from_numpy(p["labels"][p["train"]]), p["n"])
    eps = torch.zeros((1, len(p["train"]), 3))
    val, _ = tvar._elbo(p["tparams"], eps, p["ttr"], p["tm"], *args,
                        jitter=-100.0)
    assert torch.isnan(val)
    jval, _ = jvar.elbo(p["jparams"], jax.random.PRNGKey(0), p["jtr"], p["jm"],
                        jnp.asarray(p["inducing"]), jnp.asarray(p["train"]),
                        jnp.asarray(p["labels"][p["train"]]), p["n"], 3,
                        n_mc=1, jitter=-100.0)
    assert np.isnan(float(jval))
