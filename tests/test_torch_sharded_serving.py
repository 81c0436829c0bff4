"""PyTorch port, sharded serving (``serving.ShardedServeState`` and the
fleet over it) on 2- and 4-shard serving meshes of gloo ranks on the CPU —
the twin of tests/test_sharded_serving.py.

One module-scoped spawn of 4 ranks runs both meshes (the 2-shard mesh is a
subgroup of the first two ranks; the others sit it out) and every check;
each rank saves what it returned, and the tests read those files.  The
ranks import no JAX; the JAX reference is computed here.

Tolerances.  Within the port the sharded answers are held to the
single-device ones bit for bit where the plain cross-Gram allows it: the
sharded path sums each rank's [q, capacity/P] block into zeros, which is
exact, but the plain ``gram_block`` is an ``einsum`` whose CPU matmul picks
its blocking (and so an entry's summation order) by the operand shapes, so
a narrower column block may round an entry differently.  Where an answer
is not bit-equal it is held to 1e-6 of scale, and the test names that
cause.  Padded batches (q not a multiple of the shard count) are held to
JAX's own rtol 1e-5 / atol 1e-6.  Against JAX's single-device state the
answers after the faulted refit agree to 1e-4 of scale, as in
tests/test_torch_serving.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as tmesh  # noqa: E402

CFG = dict(n_walkers=6, p_halt=0.25, l_max=4)
CAPACITY = 32
RANKS = 4
QS = (16, 8, 7, 1)


def _state(seed, f):
    from repro_torch import serving
    from repro_torch.core import walks
    from repro_torch.graphs import generators

    g = generators.grid2d(12, 12, device="cpu")
    rng = np.random.default_rng(0)
    obs = rng.choice(144, 20, replace=False).astype(np.int32)
    y = rng.standard_normal(20).astype(np.float32)
    empty = serving.init_state(g, seed, torch.from_numpy(f), 0.05, CAPACITY,
                               walks.WalkConfig(**CFG))
    return serving.ingest(empty, obs, y)


def _pair(got, want):
    """(bit-equal, max |got − want| / max |want|)."""
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    return bool(torch.equal(got, want)), err / max(float(want.abs().max()), 1e-30)


def _worker(rank, seed, f, out_dir):
    from repro_torch import serving
    from repro_torch.resilience import faults

    state = _state(seed, f)
    res = {}
    for n in (2, 4):
        mesh = tmesh.make_serving_mesh(n)         # a collective on every rank
        if mesh is None:
            continue
        # Every rank of a mesh must make the same calls: its own generator.
        rng = np.random.default_rng(100 + n)
        sh = serving.ShardedServeState(state, mesh=mesh)
        r = res[n] = {"moments": {}}
        for q in QS:
            qnodes = rng.choice(144, q, replace=False).astype(np.int32)
            ms, vs = sh.posterior_moments(qnodes)
            m1, v1 = serving.posterior_moments(state, qnodes)
            r["moments"][q] = (_pair(ms, m1), _pair(vs, v1))
        cand = rng.choice(144, 8, replace=False).astype(np.int32)
        ds = sh.thompson_draw(cand, torch.Generator().manual_seed(7), n_samples=3)
        d1 = serving.thompson_draw(state, cand, torch.Generator().manual_seed(7),
                                   n_samples=3)
        r["thompson"] = _pair(ds, d1)

        st2 = serving.observe_batch(state, [3, 77], [0.5, -0.2])
        st2 = serving.forget(st2, 0)
        st2 = serving.forget_batch(st2, [1, 0])
        sh.observe_batch([3, 77], [0.5, -0.2])
        sh.forget(0)
        sh.forget_batch([1, 0])
        qnodes = rng.choice(144, 12, replace=False).astype(np.int32)
        r["mut_q"] = qnodes
        ms, vs = sh.posterior_moments(qnodes)
        m1, v1 = serving.posterior_moments(st2, qnodes)
        r["mutations"] = (_pair(ms, m1), _pair(vs, v1))
        r["state_equal"] = [bool(torch.equal(a, b)) for a, b in zip(
            (sh.state.chol, sh.state.alpha, sh.state.nodes, sh.state.count),
            (st2.chol, st2.alpha, st2.nodes, st2.count))]

        with faults.use_faults("chol_fail:1"):
            st3 = serving.observe_batch(st2, [5], [1.0])     # auto refit
            sh.observe_batch([5], [1.0])
        r["refit_flags"] = (int(st3.needs_refit), int(sh.state.needs_refit))
        ms, vs = sh.posterior_moments(qnodes)
        m1, v1 = serving.posterior_moments(st3, qnodes)
        r["refit"] = (_pair(ms, m1), _pair(vs, v1))
        r["refit_moments"] = (ms, vs)

        reqs_nodes = [rng.choice(144, 5, replace=False).astype(np.int32)
                      for _ in range(4)]
        sync = serving.GPServeLoop(st3, batch=8, generator=torch.Generator().manual_seed(9))
        sync_reqs = sync.run([serving.GPRequest(nodes=nn) for nn in reqs_nodes])
        fleet = serving.GPFleetLoop(serving.ShardedServeState(st3, mesh=mesh), batch=8,
                                    generator=torch.Generator().manual_seed(9))
        fleet_reqs = fleet.run([serving.GPRequest(nodes=nn) for nn in reqs_nodes])
        r["fleet"] = [(a.done and b.done,
                       *(_pair(torch.from_numpy(getattr(b, k)), torch.from_numpy(getattr(a, k)))
                         for k in ("mean", "var", "draw")))
                      for a, b in zip(sync_reqs, fleet_reqs)]
    try:
        serving.ShardedServeState(state, n_shards=3)
        res["cap3"] = "no error"
    except ValueError as e:
        res["cap3"] = str(e)
    torch.save(res, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jax = pytest.importorskip("jax")
    from repro.core import modulation, walks

    d = tmp_path_factory.mktemp("sharded")
    mod = modulation.diffusion(l_max=CFG["l_max"])
    f = np.array(mod(mod.init(jax.random.PRNGKey(1))), np.float32)
    seed = int(walks.walk_seed(jax.random.PRNGKey(0)))
    tmesh.spawn_ranks(_worker, RANKS, init_method=f"file://{d}/store",
                      timeout_s=120, args=(seed, f, str(d)))
    return seed, f, [torch.load(d / f"rank{r}.pt", weights_only=False)
                     for r in range(RANKS)]


def hold(pair, n, padded=False):
    """A (bit-equal, relative error) pair at ``n`` shards: a padded batch to
    1e-5 of scale (JAX's own tolerance there); otherwise bit for bit on 2
    shards, and on 4, where each rank's plain cross-Gram block is [q, 8]
    and the CPU einsum rounds some entries differently at that width, bit
    for bit or within 1e-6 of scale."""
    equal, rel = pair
    if padded:
        assert rel <= 1e-5, rel
    elif n == 2:
        assert equal, rel
    else:
        assert equal or rel <= 1e-6, rel


def _mesh_ranks(out, n):
    return [r[n] for r in out[:n]]


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_moments_match_single_device(ranks, n):
    _, _, out = ranks
    for r in _mesh_ranks(out, n):
        for q in QS:
            for pair in r["moments"][q]:
                hold(pair, n, padded=q % n != 0)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_thompson_draw_matches_single_device(ranks, n):
    """The joint draw from a generator in the same state, q = 8."""
    _, _, out = ranks
    for r in _mesh_ranks(out, n):
        hold(r["thompson"], n)


@pytest.mark.parametrize("n", [2, 4])
def test_mutations_run_once_and_broadcast(ranks, n):
    """observe_batch / forget / forget_batch on the sharded state: every
    rank's copy of the state equals the single-device result bit for bit
    (rank 0 computed it; the others received it), and the answers after
    match."""
    _, _, out = ranks
    for r in _mesh_ranks(out, n):
        assert all(r["state_equal"]), r["state_equal"]
        for pair in r["mutations"]:
            hold(pair, n)


@pytest.mark.parametrize("n", [2, 4])
def test_faulted_refit_keeps_parity(ranks, n):
    """A chol_fail:1 append (needs_refit) answered by the refit fallback on
    both sides; the sharded answers equal the single-device ones, are the
    same on every rank, and agree with JAX's single-device state to 1e-4 of
    scale."""
    import jax
    import jax.numpy as jnp
    from repro import serving as jserving
    from repro.core import walks as jwalks
    from repro.graphs import generators as jgen
    from repro.resilience import faults as jfaults

    seed, f, out = ranks
    rs = _mesh_ranks(out, n)
    for r in rs:
        assert r["refit_flags"] == (0, 0)
        for pair in r["refit"]:
            hold(pair, n)
        for a, b in zip(r["refit_moments"], rs[0]["refit_moments"]):
            assert torch.equal(a, b)
    rng = np.random.default_rng(0)
    obs = rng.choice(144, 20, replace=False).astype(np.int32)
    y = rng.standard_normal(20).astype(np.float32)
    st = jserving.ingest(jserving.init_state(
        jgen.grid2d(12, 12), jax.random.PRNGKey(0), jnp.asarray(f), 0.05,
        capacity=CAPACITY, cfg=jwalks.WalkConfig(**CFG)), obs, y)
    st = jserving.observe_batch(st, [3, 77], [0.5, -0.2])
    st = jserving.forget_batch(jserving.forget(st, 0), [1, 0])
    with jfaults.use_faults("chol_fail:1"):
        st = jserving.observe_batch(st, [5], [1.0])
    assert int(st.needs_refit) == 0
    want = jserving.posterior_moments(st, jnp.asarray(rs[0]["mut_q"]))
    for got, w in zip(rs[0]["refit_moments"], want):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got.numpy() / scale, w / scale, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [2, 4])
def test_fleet_over_sharded_state_matches_sync_engine(ranks, n):
    """GPFleetLoop over the sharded state answers the sync single-device
    engine's request stream, wave for wave (the same generator seed)."""
    _, _, out = ranks
    for r in _mesh_ranks(out, n):
        for done, *pairs in r["fleet"]:
            assert done
            for pair in pairs:
                hold(pair, n)


def test_capacity_must_divide_across_shards(ranks):
    _, _, out = ranks
    for r in out:
        assert "must divide evenly across 3 shards" in r["cap3"]


def test_serve_gp_mesh_example(capsys):
    """``serve_gp --mesh 2 --device cpu`` spawns two gloo ranks, checks the
    sharded moments against the single-device ones and drives the fleet
    over the sharded state (the example's own assertions are the gate)."""
    from repro_torch.examples import serve_gp

    serve_gp.main(["--nodes", "3000", "--mesh", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "re-serving over a 2-rank gloo serving mesh" in out


# --- on the card: world size 1 under NCCL ------------------------------------


@pytest.fixture
def nccl_mesh(tmp_path):
    """A 1-rank NCCL process group in this process and its serving mesh:
    NCCL puts no two ranks on one card, so one card runs world size 1 —
    the collectives are real NCCL calls and the kernels run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield tmesh.make_serving_mesh()
    finally:
        dist.destroy_process_group()


def _card_state(dev):
    from repro_torch import serving
    from repro_torch.core import modulation, walks
    from repro_torch.graphs import generators

    g = generators.grid2d(12, 12, device=dev)
    mod = modulation.diffusion(l_max=CFG["l_max"])
    rng = np.random.default_rng(0)
    obs = rng.choice(144, 20, replace=False).astype(np.int32)
    y = rng.standard_normal(20).astype(np.float32)
    empty = serving.init_state(g, 1214163296, mod(mod.init(device=dev)), 0.05,
                               CAPACITY, walks.WalkConfig(**CFG))
    return serving.ingest(empty, obs, y)


@pytest.mark.gpu
def test_gpu_sharded_state_at_world_size_one(nccl_mesh):
    """ShardedServeState on the card under NCCL at world size 1: moments,
    the Thompson draw, the mutations, the faulted refit and the fleet over
    it equal the single-device state's, bit for bit; gram_block and the
    walk sampler launched."""
    from repro_torch import serving
    from repro_torch.kernels import dispatch
    from repro_torch.resilience import faults

    dev = torch.device("cuda", 0)
    state = _card_state(dev)
    rng = np.random.default_rng(5)
    dispatch.reset_launch_counts()
    sh = serving.ShardedServeState(state, mesh=nccl_mesh)

    def same(qnodes, single):
        for a, b in zip(sh.posterior_moments(qnodes),
                        serving.posterior_moments(single, qnodes)):
            assert torch.equal(a, b)

    same(rng.choice(144, 16, replace=False).astype(np.int32), state)
    cand = rng.choice(144, 8, replace=False).astype(np.int32)
    gen = lambda: torch.Generator(device=dev).manual_seed(7)  # noqa: E731
    assert torch.equal(sh.thompson_draw(cand, gen(), n_samples=3),
                       serving.thompson_draw(state, cand, gen(), n_samples=3))
    st2 = serving.forget_batch(serving.forget(
        serving.observe_batch(state, [3, 77], [0.5, -0.2]), 0), [1, 0])
    sh.observe_batch([3, 77], [0.5, -0.2])
    sh.forget(0)
    sh.forget_batch([1, 0])
    q12 = rng.choice(144, 12, replace=False).astype(np.int32)
    same(q12, st2)
    with faults.use_faults("chol_fail:1"):
        st3 = serving.observe_batch(st2, [5], [1.0])
        sh.observe_batch([5], [1.0])
    assert int(st3.needs_refit) == 0 == int(sh.state.needs_refit)
    same(q12, st3)
    reqs = [rng.choice(144, 5, replace=False).astype(np.int32) for _ in range(4)]
    gen9 = lambda: torch.Generator(device=dev).manual_seed(9)  # noqa: E731
    sync = serving.GPServeLoop(st3, batch=8, generator=gen9()).run(
        [serving.GPRequest(nodes=nn) for nn in reqs])
    fleet = serving.GPFleetLoop(serving.ShardedServeState(st3, mesh=nccl_mesh),
                                batch=8, generator=gen9()).run(
        [serving.GPRequest(nodes=nn) for nn in reqs])
    for a, b in zip(sync, fleet):
        assert a.done and b.done
        for k in ("mean", "var", "draw"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    counts = dispatch.launch_counts()
    assert counts["gram_block"] > 0 and counts["walk_sampler"] > 0
