"""PyTorch port, the async serving fleet: ``GPFleetLoop``, the no-sync
mutation paths (``observe_batch_async``, ``forget_batch_async``) and
``refit_alpha(donate=True)`` — twins of tests/test_fleet.py.

Within the port, as the JAX tests hold it: the fleet answers what the sync
``GPServeLoop`` answers and its coalesced mutations equal the eager ones,
bit for bit; the async paths equal their eager counterparts bit for bit,
donated or not.  Against the JAX package (same graph, same uint32 walk
seed, same f, σ² and observations; JAX's "xla" path): one result of each
test — states and the answers' means and variances — to 1e-4 of scale
(``TOL``, as tests/test_torch_serving.py: everything passes through a
Cholesky factor and triangular solves); the draws come from each package's
own generator and are compared within the port only.

Donation is the in-place form (serving/update.py): a donated call writes
the input state's tensors, so the test shows aliasing by ``data_ptr`` and
that the old state object reads the new values.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop, serving  # noqa: E402
from repro_torch.core import walks as twalks  # noqa: E402
from repro_torch.serving import update as tupdate  # noqa: E402

TOL = 1e-4
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
    float leaves to ``tol`` of scale (as tests/test_torch_serving.py)."""
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


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules (imported here, never at module import:
    the card's machine has no JAX, and this file's gpu tests run there)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import serving as jserving
    from repro.core import modulation as jmod
    from repro.core import walks as jwalks
    from repro.graphs import generators as jgen
    from repro.serving import update as jupdate
    return types.SimpleNamespace(jax=jax, jnp=jnp, serving=jserving, mod=jmod,
                                 walks=jwalks, gen=jgen, update=jupdate)


@pytest.fixture(scope="module")
def setup(J):
    """(port state, JAX state): 12 observations ingested in both."""
    j_cfg = J.walks.WalkConfig(n_walkers=6, p_halt=0.25, l_max=4)
    jg = J.gen.grid2d(10, 10)
    tg = interop.graph_from_numpy(jg.neighbors, jg.weights, jg.deg, device="cpu")
    m = J.mod.diffusion(l_max=j_cfg.l_max)
    f = np.array(m(m.init(J.jax.random.PRNGKey(1))))
    key = J.jax.random.PRNGKey(0)
    rng = np.random.default_rng(0)
    obs = rng.choice(100, 12, replace=False).astype(np.int32)
    y = rng.standard_normal(12).astype(np.float32)
    j = J.serving.ingest(J.serving.init_state(jg, key, J.jnp.asarray(f), S2,
                                              capacity=CAPACITY, cfg=j_cfg), obs, y)
    t = serving.ingest(serving.init_state(tg, int(J.walks.walk_seed(key)),
                                          torch.from_numpy(f), S2, CAPACITY, T_CFG),
                       obs, y)
    return t, j


def _fresh(state):
    """A private copy of the mutable tensors (a donated update writes its
    input state in place; the fleet makes such a copy itself)."""
    return tupdate.copy_mutable(state)


def _jfresh(J, state):
    packed = J.jax.tree.map(lambda x: J.jnp.array(x, copy=True),
                            J.update._pack(state))
    return J.update._unpack(state, packed)


def _requests(rng, n_reqs=5, q=6):
    return [rng.choice(100, q, replace=False).astype(np.int32)
            for _ in range(n_reqs)]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _bitwise(a, b):
    for leaf in ("nodes", "y", "count", "chol", "alpha", "overflow", "rejected",
                 "needs_refit"):
        assert torch.equal(getattr(a, leaf), getattr(b, leaf)), leaf
    for f in ("cols", "loads", "lens"):
        assert torch.equal(getattr(a.trace, f), getattr(b.trace, f)), f


def test_fleet_matches_sync_engine(J, setup):
    """Same state, same generator seed, same request stream: the
    double-buffered fleet answers exactly what the blocking GPServeLoop
    answers; the means and variances match JAX's fleet."""
    t, j = setup
    streams = _requests(np.random.default_rng(1))
    sync = serving.GPServeLoop(t, batch=8, generator=_gen(3))
    got_sync = sync.run([serving.GPRequest(nodes=nn) for nn in streams])
    fleet = serving.GPFleetLoop(t, batch=8, generator=_gen(3), donate=False)
    got_fleet = fleet.run([serving.GPRequest(nodes=nn) for nn in streams])
    jfleet = J.serving.GPFleetLoop(j, batch=8, key=J.jax.random.PRNGKey(3), donate=False)
    got_j = jfleet.run([J.serving.GPRequest(nodes=nn) for nn in streams])
    for a, b, c in zip(got_sync, got_fleet, got_j):
        assert a.done and b.done
        np.testing.assert_array_equal(a.mean, b.mean)
        np.testing.assert_array_equal(a.var, b.var)
        np.testing.assert_array_equal(a.draw, b.draw)
        close(b.mean, c.mean)
        close(b.var, c.var)


def test_fleet_mutations_match_eager_sequence(J, setup):
    """Queued observe/forget runs are coalesced, and the result equals the
    same ops applied eagerly in order (bitwise), and JAX's fleet."""
    t, j = setup
    want = serving.observe_batch(t, [7, 42, 9], [0.1, -0.5, 1.2])
    want = serving.forget_batch(want, [0, 0])
    want = serving.observe_batch(want, [55], [0.3])

    def drive(pkg, state, **kw):
        fleet = pkg.GPFleetLoop(state, batch=8, donate=False, **kw)
        assert fleet.submit_observe([7, 42], [0.1, -0.5])
        assert fleet.submit_observe([9], [1.2])      # coalesces with the above
        assert fleet.submit_forget(0)
        assert fleet.submit_forget(0)                # one forget call
        assert fleet.submit_observe([55], [0.3])
        fleet.drain()
        return fleet.serve_state

    got = drive(serving, t)
    _bitwise(want, got)
    same_state(got, drive(J.serving, j))


def test_fleet_fifo_across_op_kinds(J, setup):
    """A query submitted BEFORE an observe is answered from the older state;
    one submitted after sees the append."""
    t, j = setup
    q = np.asarray([3, 17], np.int32)

    def drive(pkg, state, **kw):
        fleet = pkg.GPFleetLoop(state, batch=8, donate=False, **kw)
        before, after = pkg.GPRequest(nodes=q), pkg.GPRequest(nodes=q)
        assert fleet.submit(before)
        # node 4 is one hop from queried node 3: the posterior there moves
        assert fleet.submit_observe([4], [2.0])
        assert fleet.submit(after)
        fleet.drain()
        return before, after

    before, after = drive(serving, t, generator=_gen(5))
    m_old, v_old = serving.posterior_moments(t, q)
    m_new, v_new = serving.posterior_moments(serving.observe_batch(t, [4], [2.0]), q)
    np.testing.assert_array_equal(before.mean, m_old.numpy())
    np.testing.assert_array_equal(after.mean, m_new.numpy())
    assert not torch.equal(v_old, v_new)
    jb, ja = drive(J.serving, j, key=J.jax.random.PRNGKey(5))
    close(before.mean, jb.mean)
    close(after.var, ja.var)


def test_fleet_backpressure(J, setup):
    t, j = setup
    for pkg, state in ((serving, _fresh(t)), (J.serving, _jfresh(J, j))):
        fleet = pkg.GPFleetLoop(state, batch=4, max_pending=2)   # donating
        assert fleet.submit_observe([1], [0.0])
        assert fleet.submit(pkg.GPRequest(nodes=np.asarray([2], np.int32)))
        assert not fleet.submit_forget(0)            # queue full -> refused
        assert not fleet.submit(pkg.GPRequest(nodes=np.asarray([3], np.int32)))
        fleet.drain()                                 # makes room again
        assert fleet.submit_forget(0)
        fleet.drain()
        if pkg is serving:
            got = fleet.serve_state
        else:
            same_state(got, fleet.serve_state)


def test_donated_updates_alias_and_invalidate(J, setup):
    """The donated paths write the input state's tensors in place: the
    returned state's tensors are the input's (same ``data_ptr``), the old
    state object reads the new values, the graph is untouched; without
    donation the input is left as it was."""
    t, j = setup

    def ptrs(st):
        return [x.data_ptr() for x in (st.nodes, st.y, st.count, st.chol, st.alpha,
                                       st.overflow, st.rejected, st.needs_refit,
                                       st.trace.cols, st.trace.loads, st.trace.lens)]

    st = serving.ingest(t, np.asarray([1, 2, 3], np.int32), np.asarray([0.3, -0.2, 0.5], np.float32))
    graph_before = st.graph.neighbors.clone()
    before = ptrs(st)
    new = serving.observe_batch_async(st, [4], [0.5], donate=True)
    assert ptrs(new) == before
    assert int(st.count) == 4 and torch.equal(st.chol, new.chol)
    assert new.graph.neighbors is st.graph.neighbors
    assert torch.equal(st.graph.neighbors, graph_before)
    jst = J.serving.ingest(j, np.asarray([1, 2, 3], np.int32), np.asarray([0.3, -0.2, 0.5], np.float32))
    jnew = J.serving.observe_batch_async(jst, [4], [0.5], donate=True)
    same_state(new, jnew)

    new2 = serving.forget_batch_async(new, [0], donate=True)
    assert ptrs(new2) == before and int(st.count) == 3
    assert torch.equal(st.chol, new2.chol)
    same_state(new2, J.serving.forget_batch_async(jnew, [0], donate=True))

    old_alpha = new2.alpha
    ra = serving.refit_alpha(new2, f=new2.f * 1.1, donate=True)
    assert ra.alpha.data_ptr() == old_alpha.data_ptr()
    assert torch.equal(new2.alpha, ra.alpha)

    st = serving.ingest(t, np.asarray([1, 2, 3], np.int32), np.asarray([0.3, -0.2, 0.5], np.float32))
    keep = _fresh(st)
    new = serving.observe_batch_async(st, [4], [0.5], donate=False)
    assert ptrs(new) != ptrs(st)
    _bitwise(st, keep)
    ra = serving.refit_alpha(st, f=st.f * 1.1, donate=False)
    assert torch.equal(st.alpha, keep.alpha) and not torch.equal(ra.alpha, st.alpha)


def test_fleet_donated_run_matches_undonated(J, setup):
    """donate=True changes where the values are written, never answers."""
    t, j = setup
    streams = _requests(np.random.default_rng(7), n_reqs=3)

    def drive(pkg, state, donate, **kw):
        fleet = pkg.GPFleetLoop(state, batch=8, donate=donate, **kw)
        fleet.submit_observe([33, 44], [0.2, -0.1])
        reqs = [pkg.GPRequest(nodes=nn) for nn in streams]
        for r in reqs:
            assert fleet.submit(r)
        fleet.submit_forget(0)
        fleet.drain()
        return reqs, fleet.serve_state

    given = _fresh(t)
    got_d, st_d = drive(serving, given, True, generator=_gen(11))
    _bitwise(given, t)            # the fleet donated its own copy, not ours
    got_u, st_u = drive(serving, _fresh(t), False, generator=_gen(11))
    for a, b in zip(got_d, got_u):
        np.testing.assert_array_equal(a.mean, b.mean)
        np.testing.assert_array_equal(a.draw, b.draw)
    _bitwise(st_d, st_u)
    got_j, st_j = drive(J.serving, _jfresh(J, j), True, key=J.jax.random.PRNGKey(11))
    same_state(st_d, st_j)
    for a, b in zip(got_d, got_j):
        close(a.mean, b.mean)


def test_fleet_overflow_flag_surfaces(J, setup):
    """Appends past capacity degrade to the masked drop; the lazy flag
    check surfaces them as counters, never an exception."""
    t, j = setup
    free = CAPACITY - int(t.count)
    out = []
    for pkg, state in ((serving, _fresh(t)), (J.serving, _jfresh(J, j))):
        fleet = pkg.GPFleetLoop(state, batch=4, flag_check_every=1)
        fleet.submit_observe(np.zeros(free + 3, np.int32),
                             np.zeros(free + 3, np.float32))
        fleet.drain()
        st = fleet.serve_state
        assert int(st.count) == CAPACITY and int(st.overflow) == 3
        assert np.isfinite(np.asarray(st.chol)).all()
        out.append(st)
    same_state(*out)


@pytest.mark.parametrize("donate", [False, True])
def test_observe_batch_async_equals_the_eager_reject_path(J, setup, donate):
    """observe_batch_async == observe_batch(on_overflow="reject",
    auto_refit=False), bit for bit — within capacity and past it."""
    t, _ = setup
    free = CAPACITY - int(t.count)
    rng = np.random.default_rng(2)
    for n in (3, free + 2):
        nodes = rng.integers(0, 100, n).astype(np.int32)
        ys = rng.standard_normal(n).astype(np.float32)
        want = serving.observe_batch(t, nodes, ys, on_overflow="reject",
                                     auto_refit=False)
        got = serving.observe_batch_async(_fresh(t), nodes, ys, donate=donate)
        _bitwise(want, got)


@pytest.mark.parametrize("donate", [False, True])
def test_forget_batch_async_equals_forget_batch(J, setup, donate):
    """forget_batch_async sweeps to a bound on the live count (capacity by
    default) without reading the count, and equals forget_batch bit for bit
    at any bound at or above the count (including the last live slot)."""
    t, _ = setup
    m = int(t.count)
    for slots in ([0], [3, 0, 7], [m - 1], [0, 0, 0, 0]):
        want = serving.forget_batch(t, slots)
        for bound in (None, m, m + 5):
            got = serving.forget_batch_async(_fresh(t), slots, donate=donate,
                                             live_bound=bound)
            _bitwise(want, got)


# --- on the card --------------------------------------------------------------

CARD_SEED = 1214163296


@pytest.fixture
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def card_state(dev, capacity=CAPACITY, n_obs=12):
    """The fixture's problem built by the port alone (the card's machine
    has no JAX): grid2d(10, 10), the golden walk seed, diffusion f."""
    from repro_torch.core import modulation
    from repro_torch.graphs import generators

    g = generators.grid2d(10, 10, device=dev)
    mod = modulation.diffusion(l_max=T_CFG.l_max)
    f = mod(mod.init(device=dev))
    rng = np.random.default_rng(0)
    obs = rng.choice(100, n_obs, replace=False).astype(np.int32)
    y = rng.standard_normal(n_obs).astype(np.float32)
    empty = serving.init_state(g, CARD_SEED, f, S2, capacity, T_CFG)
    return serving.ingest(empty, obs, y)


@pytest.mark.gpu
def test_gpu_fleet_matches_sync_engine_and_eager_mutations(cuda):
    """On the card: the fleet's answers equal the sync engine's and its
    coalesced mutations the eager ones, bit for bit; the async paths equal
    their eager counterparts bit for bit, donated or not."""
    t = card_state(cuda)
    streams = _requests(np.random.default_rng(1))
    gen = lambda: torch.Generator(device=cuda).manual_seed(3)  # noqa: E731
    sync = serving.GPServeLoop(t, batch=8, generator=gen())
    got_sync = sync.run([serving.GPRequest(nodes=nn) for nn in streams])
    fleet = serving.GPFleetLoop(_fresh(t), batch=8, generator=gen())
    got_fleet = fleet.run([serving.GPRequest(nodes=nn) for nn in streams])
    for a, b in zip(got_sync, got_fleet):
        assert a.done and b.done
        for k in ("mean", "var", "draw"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    want = serving.observe_batch(t, [7, 42, 9], [0.1, -0.5, 1.2])
    want = serving.observe_batch(serving.forget_batch(want, [0, 0]), [55], [0.3])
    fleet = serving.GPFleetLoop(_fresh(t), batch=8)
    fleet.submit_observe([7, 42], [0.1, -0.5])
    fleet.submit_observe([9], [1.2])
    fleet.submit_forget(0)
    fleet.submit_forget(0)
    fleet.submit_observe([55], [0.3])
    fleet.drain()
    _bitwise(want, fleet.serve_state)
    for donate in (False, True):
        _bitwise(serving.observe_batch(t, [5, 6, 5], [0.2, 0.1, -0.3],
                                       on_overflow="reject", auto_refit=False),
                 serving.observe_batch_async(_fresh(t), [5, 6, 5], [0.2, 0.1, -0.3],
                                             donate=donate))
        _bitwise(serving.forget_batch(t, [3, 0, 7]),
                 serving.forget_batch_async(_fresh(t), [3, 0, 7], donate=donate))


@pytest.mark.gpu
def test_gpu_dispatch_half_makes_no_host_sync(cuda):
    """``fleet.step()``'s dispatch half — the coalesced async mutations,
    admission and the wave's dispatch — and ``observe_batch_async`` /
    ``forget_batch_async`` themselves run under
    ``torch.cuda.set_sync_debug_mode("error")`` without raising: no call on
    the path waits for the card.  The answers are read only after the
    wave's event, and equal ``posterior_moments`` on the same nodes (to
    1e-6: another query-block width, as in tests/test_torch_serving.py)."""
    t = card_state(cuda)
    q = np.arange(0, 100, 7, dtype=np.int32)

    def drive(fleet):
        fleet.submit_observe([11, 12], [0.4, -0.4])
        fleet.submit_forget(0)
        req = serving.GPRequest(nodes=q)
        fleet.submit(req)
        return req

    warm = serving.GPFleetLoop(_fresh(t), batch=16)   # builds the kernels
    drive(warm)
    warm.drain()
    fleet = serving.GPFleetLoop(_fresh(t), batch=16, flag_check_every=0)
    req = drive(fleet)
    assert fleet._reap() == 0                   # nothing in flight yet
    torch.cuda.set_sync_debug_mode("error")
    try:
        fleet._process_mutations()
        fleet._admit_pending()
        fleet._dispatch()
        st = serving.observe_batch_async(fleet.serve_state, [21], [0.1])
        st = serving.forget_batch_async(st, [1])
        other = serving.observe_batch_async(st, [22], [0.2], donate=False)
        serving.forget_batch_async(other, [0], donate=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fleet._inflight is not None and not req.done
    assert fleet._reap() == len(q) and req.done
    ref = serving.observe_batch(t, [11, 12], [0.4, -0.4])
    ref = serving.forget(ref, 0)
    m, v = serving.posterior_moments(ref, q)
    np.testing.assert_allclose(req.mean, m.cpu().numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(req.var, v.cpu().numpy(), rtol=1e-6, atol=1e-7)
