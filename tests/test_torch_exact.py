"""PyTorch port, the paper's exact baselines against the JAX package:
Laplacian eigendecomposition and the dense graph kernels, the exact GP
(Cholesky posterior, exact NLML, exact-diffusion fit), ``nnz_per_row`` and
the JLT + Woodbury solver.

Tolerances, relative to the result's scale: eigenvalues and kernels built
from them 1e-5 (eigenvectors are never compared: grid spectra repeat, and
the two eigensolvers pick different bases of each eigenspace); the
Cholesky posterior, NLML and the Woodbury solve 1e-5; 20 Adam steps of the
exact fit 1e-4 (the LML gradient passes through a Cholesky each step);
integers exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import features as jfeat  # noqa: E402
from repro.core import jlt as jjlt  # noqa: E402
from repro.core import kernels_exact as jke  # noqa: E402
from repro.core import modulation as jmod  # noqa: E402
from repro.core import walks as jwalks  # noqa: E402
from repro.gp import exact as jexact  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.graphs.formats import to_dense  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import features as tfeat  # noqa: E402
from repro_torch.core import jlt as tjlt  # noqa: E402
from repro_torch.core import kernels_exact as tke  # noqa: E402
from repro_torch.core import walks as twalks  # noqa: E402
from repro_torch.gp import exact as texact  # noqa: E402
from repro_torch.solvers import cg_solve  # noqa: E402

CPU = "cpu"
TOL = 1e-5
FIT_TOL = 1e-4
SEED = 1214163296


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def graphs(name):
    jg = jgen.ring(32) if name == "ring32" else jgen.grid2d(6, 6)
    return jg, interop.graph_from_numpy(jg.neighbors, jg.weights, jg.deg,
                                        device=CPU)


@pytest.fixture(params=["ring32", "grid6x6"])
def pair(request):
    return graphs(request.param)


def test_laplacian_eigenvalues(pair):
    jg, tg = pair
    jev, _ = jke.laplacian_eigh(jg)
    tev, tvec = tke.laplacian_eigh(tg)
    close(tev, jev, TOL)
    # The port's basis diagonalises the JAX package's L̃ (the JAX basis
    # differs from it by rotations within repeated eigenvalues).
    want = np.eye(tg.n_nodes) - np.asarray(to_dense(jg))
    close((tvec * tev) @ tvec.T, want, TOL)


@pytest.mark.parametrize("kind", ["diffusion", "matern", "power_series"])
def test_dense_kernels(pair, kind):
    jg, tg = pair
    if kind == "diffusion":
        want = jke.diffusion_kernel(jg, beta=2.5, sigma_f=1.3)
        got = tke.diffusion_kernel(tg, beta=2.5, sigma_f=1.3)
    elif kind == "matern":
        want = jke.matern_kernel(jg, nu=1.5, kappa=0.8, sigma_f=0.7)
        got = tke.matern_kernel(tg, nu=1.5, kappa=0.8, sigma_f=0.7)
    else:
        f = np.asarray([1.0, 0.6, 0.3, 0.15, 0.05], np.float32)
        want = jke.truncated_power_series_kernel(jg, jnp.asarray(f))
        got = tke.truncated_power_series_kernel(tg, torch.from_numpy(f))
    close(got, want, TOL)


def test_kernels_take_a_given_eigendecomposition():
    _, tg = graphs("grid6x6")
    eig = tke.laplacian_eigh(tg)
    assert torch.equal(tke.diffusion_kernel(tg, 2.0, eig=eig),
                       tke.diffusion_kernel(tg, 2.0))


@pytest.fixture(scope="module")
def dense_problem():
    jg, tg = graphs("grid6x6")
    k = np.array(jke.diffusion_kernel(jg, beta=2.0), np.float32)
    rng = np.random.default_rng(0)
    train = np.sort(rng.choice(36, 12, replace=False)).astype(np.int32)
    y = rng.standard_normal(12).astype(np.float32)
    return jg, tg, k, train, y


def test_cholesky_posterior(dense_problem):
    _, _, k, train, y = dense_problem
    jm, jv = jexact.cholesky_posterior(jnp.asarray(k), jnp.asarray(train),
                                       jnp.asarray(y), jnp.float32(0.05))
    tm, tv = texact.cholesky_posterior(torch.from_numpy(k),
                                       torch.from_numpy(train),
                                       torch.from_numpy(y), 0.05)
    close(tm, jm, TOL)
    close(tv, jv, TOL)


def test_exact_nlml(dense_problem):
    _, _, k, train, y = dense_problem
    k_xx = k[np.ix_(train, train)]
    want = jexact.exact_nlml(jnp.asarray(k_xx), jnp.asarray(y), jnp.float32(0.1))
    got = texact.exact_nlml(torch.from_numpy(k_xx), torch.from_numpy(y), 0.1)
    close(got, want, TOL)


def test_fit_exact_diffusion_20_steps(dense_problem):
    jg, tg, _, train, y = dense_problem
    jp, jk = jexact.fit_exact_diffusion(jg, jnp.asarray(train), jnp.asarray(y),
                                        steps=20, lr=0.05)
    tp, tk = texact.fit_exact_diffusion(tg, torch.from_numpy(train),
                                        torch.from_numpy(y), steps=20, lr=0.05)
    assert set(tp) == set(jp) == {"log_beta", "log_sigma_f", "log_sigma_n"}
    for name in jp:
        close(tp[name], jp[name], FIT_TOL)
    close(tk, jk, FIT_TOL)
    # The JAX parameters carry across through interop unchanged.
    carried = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, device=CPU)
    assert set(carried) == set(jp)


def test_cholesky_failure_gives_nan_not_an_exception():
    """A non-PD input gives a NaN factor (the JAX package's behaviour,
    without a host read), so the posterior and the NLML come out NaN."""
    a = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    assert torch.isnan(texact.cholesky_or_nan(a)).all()
    good = torch.tensor([[2.0, 1.0], [1.0, 2.0]])
    assert torch.equal(texact.cholesky_or_nan(good), torch.linalg.cholesky(good))
    batch = torch.stack([a, good])
    out = texact.cholesky_or_nan(batch)
    assert torch.isnan(out[0]).all() and torch.isfinite(out[1]).all()
    k = torch.tensor([[1.0, 3.0, 0.0], [3.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    mean, var = texact.cholesky_posterior(k, torch.tensor([0, 1]),
                                          torch.tensor([1.0, -1.0]), 0.0)
    assert torch.isnan(mean).all()
    assert torch.isnan(texact.exact_nlml(k[:2, :2], torch.tensor([1.0, 2.0]), 0.0))


def _trace_pair(jg, tg, n_walkers, l_max, p_halt=0.2):
    ttr = twalks.sample_walks(tg, SEED, n_walkers=n_walkers, p_halt=p_halt,
                              l_max=l_max)
    jtr = jwalks.WalkTrace(jnp.asarray(ttr.cols.numpy()),
                           jnp.asarray(ttr.loads.numpy()),
                           jnp.asarray(ttr.lens.numpy()))
    return jtr, ttr


def test_nnz_per_row_equal_as_integers():
    jg, tg = graphs("ring32")
    jtr, ttr = _trace_pair(jg, tg, n_walkers=6, l_max=4)
    got = tfeat.nnz_per_row(ttr)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfeat.nnz_per_row(jtr)))
    # Duplicate live columns count once; dead slots never count.
    tr = twalks.WalkTrace(cols=torch.tensor([[3, 3, 5, 5, 7]], dtype=torch.int32),
                          loads=torch.tensor([[1.0, 2.0, 0.0, 1.0, 0.0]]),
                          lens=torch.zeros((1, 5), dtype=torch.int32))
    assert tfeat.nnz_per_row(tr).tolist() == [2]


@pytest.fixture(scope="module")
def jlt_problem():
    """The JAX posterior test's problem: grid2d(7, 7), 30 walkers, l_max 6."""
    jg = jgen.grid2d(7, 7)
    tg = interop.graph_from_numpy(jg.neighbors, jg.weights, jg.deg, device=CPU)
    jtr, ttr = _trace_pair(jg, tg, n_walkers=30, l_max=6)
    jm = jmod.diffusion(l_max=6)
    jf = jm(jm.init(jax.random.PRNGKey(1)))
    tf = torch.from_numpy(np.array(jf))
    rng = np.random.default_rng(0)
    train = rng.choice(49, 18, replace=False).astype(np.int32)
    y = rng.standard_normal(18).astype(np.float32)
    return jtr, ttr, jf, tf, train, y


def test_woodbury_solve_on_the_same_k1(jlt_problem):
    # m < T: with m > T the solve cancels (b − U w ≈ 0 in float32), and two
    # summation orders part far beyond 1e-5.
    rng = np.random.default_rng(3)
    k1 = (0.3 * rng.standard_normal((18, 8))).astype(np.float32)
    b = rng.standard_normal(18).astype(np.float32)
    want = jjlt.woodbury_solve(jnp.asarray(k1), jnp.float32(0.05), jnp.asarray(b))
    got = tjlt.woodbury_solve(torch.from_numpy(k1), 0.05, torch.from_numpy(b))
    close(got, want, TOL)
    bb = rng.standard_normal((18, 3)).astype(np.float32)
    got2 = tjlt.woodbury_solve(torch.from_numpy(k1), 0.05, torch.from_numpy(bb))
    for j in range(3):
        close(got2[:, j], jjlt.woodbury_solve(jnp.asarray(k1), jnp.float32(0.05),
                                              jnp.asarray(bb[:, j])), TOL)


def test_jlt_features_are_phi_g_over_sqrt_m(jlt_problem):
    _, ttr, _, tf, train, _ = jlt_problem
    tr_x = tfeat.take_rows(ttr, torch.from_numpy(train))
    m = 256
    got = tjlt.jlt_features(tr_x, tf, torch.Generator().manual_seed(3), m, 49)
    g = torch.randn((49, m), generator=torch.Generator().manual_seed(3))
    want = tfeat.phi_matvec(tr_x, tf, g) / np.sqrt(m)
    assert got.shape == (18, m)
    assert torch.equal(got, want)


def test_jlt_woodbury_correlates_with_cg(jlt_problem):
    """The JAX test's gate: at m = 4096 the JLT solve correlates > 0.95
    with the CG solution of the same system."""
    _, ttr, _, tf, train, y = jlt_problem
    tr_x = tfeat.take_rows(ttr, torch.from_numpy(train))
    s2 = 0.05
    h = lambda v: tfeat.phi_matvec(  # noqa: E731
        tr_x, tf, tfeat.phi_t_matvec(tr_x, tf, v, 49)) + s2 * v
    want = cg_solve(h, torch.from_numpy(y), tol=1e-7, max_iters=500).x
    k1 = tjlt.jlt_features(tr_x, tf, torch.Generator().manual_seed(3), 4096, 49)
    got = tjlt.woodbury_solve(k1, s2, torch.from_numpy(y))
    corr = np.corrcoef(want.numpy(), got.numpy())[0, 1]
    assert corr > 0.95, corr
