"""PyTorch port, Thompson-sampling BO: both loops at small N on the CPU
(invariants and resume), a replay of a JAX incremental run through the
port's serving updates, and the search baselines against the JAX package.

The two packages draw their random numbers differently (``jax.random``
keys there, ``SeedSequence``-derived seeds here), so whole BO runs cannot
be compared pick for pick.  What is compared: the serving state that the
picks of a JAX run produce in both packages (same walk seed, same f and σ²,
same picks; 1e-4 of scale, as in test_torch_serving.py), and the baselines,
which are numpy on both sides and must agree exactly.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import serving as jserving  # noqa: E402
from repro.bo import baselines as jbase  # noqa: E402
from repro.bo import thompson as jthompson  # noqa: E402
from repro.core import modulation as jmod  # noqa: E402
from repro.core import walks as jwalks  # noqa: E402
from repro.gp import mll as jmll  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch import interop, serving  # noqa: E402
from repro_torch.bo import baselines as tbase  # noqa: E402
from repro_torch.bo import thompson as tthompson  # noqa: E402
from repro_torch.core import modulation as tmod  # noqa: E402
from repro_torch.core import walks as twalks  # noqa: E402
from repro_torch.graphs import generators as tgen  # noqa: E402
from repro_torch.graphs import signals as tsig  # noqa: E402

CPU = "cpu"
TOL = 1e-4


def close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def ring():
    n = 300
    g = tgen.ring(n, k=3, device=CPU)
    truth = tsig.smooth_periodic_ring(n, seed=1)
    return g, truth


def noisy(truth, seed):
    rng = np.random.default_rng(seed)
    return lambda idx: truth[np.asarray(idx)] + 0.05 * rng.standard_normal(len(idx))


def check_run(st, n_init, n_steps, batch, n):
    assert st.count == n_init + n_steps * batch and st.iteration == n_steps
    x = st.x_obs
    assert len(np.unique(x)) == len(x)      # no node queried twice
    assert x.min() >= 0 and x.max() < n
    assert len(st.regret) == n_steps
    assert all(b <= a + 1e-12 for a, b in zip(st.regret, st.regret[1:]))
    for leaf in (st.params["log_sigma_n"], *st.params["mod"].values()):
        assert bool(torch.isfinite(leaf).all())


@pytest.mark.parametrize("batch", [1, 3])
def test_incremental_loop_invariants(ring, batch):
    g, truth = ring
    cfg = twalks.WalkConfig(8, 0.2, 4)
    st = tthompson.thompson_sampling_incremental(
        g, cfg, tmod.diffusion(4), noisy(truth, 0), seed=3, n_init=12,
        n_steps=5, refit_every=3, refit_steps=3, noise_std=0.1,
        f_max=float(truth.max()), batch_size=batch, n_candidates=64)
    check_run(st, 12, 5, batch, g.n_nodes)


@pytest.mark.parametrize("chunked", [False, True])
def test_refit_loop_invariants(ring, chunked):
    g, truth = ring
    cfg = twalks.WalkConfig(8, 0.2, 4)
    kw = dict(n_init=12, n_steps=3, refit_every=2, refit_steps=3,
              noise_std=0.1, f_max=float(truth.max()), batch_size=2)
    if chunked:
        st = tthompson.thompson_sampling(None, tmod.diffusion(4), noisy(truth, 1),
                                         seed=4, graph=g, walk=cfg, chunk=128, **kw)
    else:
        tr = twalks.sample_walks(g, 99, 8, 0.2, 4)
        st = tthompson.thompson_sampling(tr, tmod.diffusion(4), noisy(truth, 1),
                                         seed=4, **kw)
    check_run(st, 12, 3, 2, g.n_nodes)


def test_chunked_and_monolithic_refit_loops_agree(ring):
    """The chunked path samples Φ with the run's walk seed; handed the trace
    of that seed, the monolithic path makes the same picks."""
    g, truth = ring
    cfg = twalks.WalkConfig(8, 0.2, 4)
    obj = lambda idx: truth[np.asarray(idx)]    # noqa: E731  (noise-free)
    kw = dict(n_init=10, n_steps=3, refit_every=2, refit_steps=2,
              noise_std=0.1, f_max=float(truth.max()))
    chk = tthompson.thompson_sampling(None, tmod.diffusion(4), obj, seed=6,
                                      graph=g, walk=cfg, chunk=64, **kw)
    tr = twalks.sample_walks(g, tthompson._stream(6, tthompson._WALK), 8, 0.2, 4)
    mono = tthompson.thompson_sampling(tr, tmod.diffusion(4), obj, seed=6, **kw)
    np.testing.assert_array_equal(chk.x_buf, mono.x_buf)


def test_incremental_resume_reproduces_uninterrupted_run():
    g = tgen.barabasi_albert(300, m=3, seed=0, device=CPU)
    deg = g.deg.numpy().astype(float)
    truth = (deg - deg.mean()) / (deg.std() + 1e-9)
    obj = lambda idx: truth[np.asarray(idx)]    # noqa: E731  (noise-free)
    cfg = twalks.WalkConfig(4, 0.25, 3)
    kw = dict(n_init=10, n_steps=6, refit_every=3, refit_steps=3,
              noise_std=0.05, f_max=float(truth.max()), n_candidates=48)
    snap = {}

    def cb(st):
        if st.iteration == 4:  # mid-cycle: not a refit round
            snap["st"] = copy.deepcopy(st)

    full = tthompson.thompson_sampling_incremental(
        g, cfg, tmod.diffusion(3), obj, 5, checkpoint_cb=cb, **kw)
    resumed = tthompson.thompson_sampling_incremental(
        g, cfg, tmod.diffusion(3), obj, 5, state=snap["st"], **kw)
    np.testing.assert_array_equal(full.x_buf, resumed.x_buf)
    assert full.regret == resumed.regret
    with pytest.raises(ValueError, match="needs"):
        tthompson.thompson_sampling_incremental(
            g, cfg, tmod.diffusion(3), obj, 5, state=snap["st"],
            **{**kw, "n_steps": 50})
    # "auto" resolves once per run and the run completes.
    auto = tthompson.thompson_sampling_incremental(
        g, cfg, tmod.diffusion(3), obj, 5,
        fit_strategy=tthompson.solvers.MLL_DEFAULT.with_(preconditioner="auto"),
        **kw)
    check_run(auto, 10, 6, 1, 300)


def test_replay_of_jax_incremental_run_matches_jax_serving():
    """Run the JAX incremental loop, then feed both packages' ingest /
    observe_batch the picks it made after its last refit, with its walk
    seed and final hyperparameters: the two ServeStates agree."""
    jg = jgen.ring(200, k=3)
    tg = interop.graph_from_numpy(jg.neighbors, jg.weights, jg.deg, device=CPU)
    truth = tsig.smooth_periodic_ring(200, seed=2)
    obj = lambda idx: truth[np.asarray(idx)]    # noqa: E731
    jcfg = jwalks.WalkConfig(6, 0.2, 4)
    tcfg = twalks.WalkConfig(6, 0.2, 4)
    key = jax.random.PRNGKey(3)
    n_init, n_steps, refit_every, batch = 10, 4, 2, 2
    jm = jmod.diffusion(4)
    st = jthompson.thompson_sampling_incremental(
        jg, jcfg, jm, obj, key, n_init=n_init, n_steps=n_steps,
        refit_every=refit_every, refit_steps=3, noise_std=0.1, batch_size=batch,
        n_candidates=40)
    # The last refit was at round 2: the state was ingested with the first
    # n_init + 2·batch observations, then rounds 2 and 3 appended a batch each.
    m0 = n_init + 2 * batch
    y_stat = st.y_buf[:m0]
    ymean, ystd = float(y_stat.mean()), float(y_stat.std()) + 1e-8
    walk_key = jax.random.fold_in(key, 7919)
    f = np.array(jm(st.params["mod"]))
    s2 = float(jmll.noise_var(st.params))
    cap = n_init + n_steps * batch
    j = jserving.init_state(jg, walk_key, jnp.asarray(f), s2, cap, jcfg)
    t = serving.init_state(tg, int(jwalks.walk_seed(walk_key)),
                           torch.from_numpy(f), s2, cap, tcfg)
    yn = (st.y_buf - ymean) / ystd
    j = jserving.ingest(j, st.x_buf[:m0], yn[:m0])
    t = serving.ingest(t, st.x_buf[:m0], yn[:m0])
    for r in range(2):
        sl = slice(m0 + r * batch, m0 + (r + 1) * batch)
        j = jserving.observe_batch(j, st.x_buf[sl], yn[sl])
        t = serving.observe_batch(t, st.x_buf[sl], yn[sl])
    assert int(t.count) == int(j.count) == cap
    np.testing.assert_array_equal(t.nodes.numpy(), np.asarray(j.nodes))
    close(t.chol, j.chol)
    close(t.alpha, j.alpha)
    q = np.arange(0, 200, 7, dtype=np.int32)
    tm, tv = serving.posterior_moments(t, torch.from_numpy(q))
    jmean, jvar = jserving.posterior_moments(j, jnp.asarray(q))
    close(tm, jmean)
    close(tv, jvar)


@pytest.mark.parametrize("name", ["random_search", "bfs_search", "dfs_search"])
def test_baselines_match_jax_exactly(name):
    jg = jgen.barabasi_albert(400, m=3, seed=1)
    tg = interop.graph_from_numpy(jg.neighbors, jg.weights, jg.deg, device=CPU)
    deg = np.asarray(jg.deg, float)
    truth = (deg - deg.mean()) / (deg.std() + 1e-9)
    want = getattr(jbase, name)(jg, noisy(truth, 7), 11, 5, 30, float(truth.max()))
    got = getattr(tbase, name)(tg, noisy(truth, 7), 11, 5, 30, float(truth.max()))
    assert got == want and len(got) == 30


@pytest.mark.parametrize("driver,argv", [
    ("serve_gp", ["--nodes", "600", "--observe", "20", "--queries", "64",
                  "--batch", "16", "--capacity", "32", "--fit-steps", "2"]),
    ("bo_social_network", ["--nodes", "600", "--steps", "3", "--init", "20",
                           "--walkers", "4", "--candidates", "64"]),
    ("bo_social_network", ["--nodes", "600", "--steps", "2", "--init", "20",
                           "--walkers", "4", "--engine", "refit"]),
])
def test_drivers_run_and_default_to_the_card(driver, argv, capsys, tmp_path):
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{driver}")
    if driver == "bo_social_network":   # a checkpoint directory of its own
        argv = argv + ["--ckpt", str(tmp_path / "ckpt")]
    out = mod.main(argv + ["--device", "cpu"])
    assert out is None
    text = capsys.readouterr().out
    assert ("queries/s" in text) if driver == "serve_gp" else ("final simple regret" in text)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(argv)
