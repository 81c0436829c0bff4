"""PyTorch port, the distributed GRF-GP (``repro_torch.distributed``) over
4 gloo ranks on the CPU — the twin of tests/test_distributed_gp.py.

One module-scoped spawn of 4 ranks (``launch.mesh.spawn_ranks``, start
method spawn, a ``file://`` store, a 120 s timeout that fails a hung
collective) runs every sharded call; each rank saves what it returned, and
the tests read those files.  The ranks import no JAX: the JAX references
are computed here, in the test process.

Tolerances, relative to the result's scale: the sharded CG against the
port's single-process solve 1e-5 (the same iterations; only the order of
the all-reduced sums differs); against JAX's single-device ``cg_solve``
JAX's own 1e-3 (1e-2 for 64 fixed iterations); the chunked solve at chunk
8 against the materialised one 1e-5; the compressed reduce against JAX's
``psum_reduce(compress=True)`` (bf16-rounded partials summed in f32, on
one device) 1e-6 — four f32 terms summed in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as tmesh  # noqa: E402

N = 64
CFG = dict(n_walkers=10, p_halt=0.2, l_max=4)
RANKS = 4


def _problem(seed, f):
    from repro_torch.core import walks
    from repro_torch.graphs import generators

    g = generators.ring(N, k=2, device="cpu")
    tr = walks.sample_walks(g, seed, **CFG)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(N).astype(np.float32))
    mask = torch.zeros(N)
    mask[:16] = 1.0
    y = torch.zeros(N)
    y[:16] = torch.from_numpy(np.random.default_rng(1).standard_normal(16).astype(np.float32))
    return g, tr, torch.from_numpy(f), b, mask, y


def _partial(rank):
    return torch.from_numpy(np.random.default_rng(10 + rank).standard_normal(N)
                            .astype(np.float32) * 3.0)


def _worker(rank, seed, f, out_dir):
    from repro_torch import solvers
    from repro_torch.core import walks
    from repro_torch.distributed import gp_shard as G

    mesh = tmesh.make_serving_mesh()
    g, tr, f, b, mask, y = _problem(seed, f)
    res = {}
    res["cg"], res["iters"], res["conv"] = G.sharded_cg_solve(
        tr, f, b, mesh, sigma_n2=0.1, tol=1e-7, max_iters=300,
        return_diagnostics=True)
    res["fixed"], res["fixed_iters"], _ = G.sharded_cg_solve(
        tr, f, b, mesh, sigma_n2=0.1, max_iters=64, fixed_unrolled=True,
        return_diagnostics=True)
    res["chunked"] = G.sharded_cg_solve_chunked(
        g, f, b, mesh, seed, walks.WalkConfig(**CFG), chunk=8, sigma_n2=0.1,
        tol=1e-7, max_iters=300)
    res["auto"] = G.sharded_cg_solve(
        tr, f, b, mesh, sigma_n2=0.1,
        strategy=solvers.SolveStrategy(preconditioner="auto", tol=1e-7, max_iters=300))
    try:
        G.sharded_cg_solve(tr, f, b, mesh, sigma_n2=0.1,
                           strategy=solvers.SolveStrategy(preconditioner="nystrom"))
        res["nystrom"] = "no error"
    except ValueError as e:
        res["nystrom"] = str(e)
    res["compress"] = G.psum_reduce(mesh, compress=True)(_partial(rank))
    res["plain_reduce"] = G.psum_reduce(mesh)(_partial(rank))
    res["sample"] = G.sharded_posterior_sample(
        tr, mask, f, y, torch.Generator().manual_seed(5), mesh, sigma_n2=0.05)
    garbage = y + (1 - mask) * 100.0          # values at unobserved rows
    res["sample_garbage"] = G.sharded_posterior_sample(
        tr, mask, f, garbage, torch.Generator().manual_seed(5), mesh, sigma_n2=0.05)
    one = tmesh.make_serving_mesh(1)          # every rank creates the subgroup
    if one is not None:
        res["sample_1"] = G.sharded_posterior_sample(
            tr, mask, f, y, torch.Generator().manual_seed(5), one, sigma_n2=0.05)
        res["cg_1"] = G.sharded_cg_solve(tr, f, b, one, sigma_n2=0.1, tol=1e-7,
                                         max_iters=300)
    torch.save(res, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jax = pytest.importorskip("jax")
    from repro.core import modulation, walks

    d = tmp_path_factory.mktemp("dist")
    mod = modulation.diffusion(l_max=CFG["l_max"])
    f = np.array(mod(mod.init(jax.random.PRNGKey(1))), np.float32)
    seed = int(walks.walk_seed(jax.random.PRNGKey(0)))
    tmesh.spawn_ranks(_worker, RANKS, init_method=f"file://{d}/store",
                      timeout_s=120, args=(seed, f, str(d)))
    return seed, f, [torch.load(d / f"rank{r}.pt") for r in range(RANKS)]


def close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def test_sharded_cg_matches_single_process(ranks):
    """Every rank returns the whole solution, and it is the port's
    single-process solve (and the 1-rank mesh's)."""
    from repro_torch import solvers
    from repro_torch.core import linops

    seed, f, out = ranks
    _, tr, ft, b, _, _ = _problem(seed, f)
    want = solvers.solve(linops.shifted(tr, ft, 0.1), b,
                         solvers.SolveStrategy(tol=1e-7, max_iters=300))
    for r in out:
        assert torch.equal(r["cg"], out[0]["cg"])
        assert r["iters"] == out[0]["iters"] and bool(r["conv"])
    close(out[0]["cg"], want.x, 1e-5)
    close(out[0]["cg_1"], want.x, 1e-5)
    assert abs(out[0]["iters"] - want.iters) <= 1


def test_sharded_cg_matches_jax_cg(ranks):
    """Against JAX's single-device cg_solve, at the JAX test's tolerances;
    the fixed variant runs exactly 64 iterations."""
    import jax
    import jax.numpy as jnp
    from repro.core import walks
    from repro.gp.mll import make_h_matvec
    from repro.solvers import cg_solve
    from repro.graphs import generators

    seed, f, out = ranks
    tr = walks.sample_walks(generators.ring(N, k=2), jax.random.PRNGKey(0), **CFG)
    b = jnp.asarray(np.random.default_rng(0).standard_normal(N), jnp.float32)
    want = cg_solve(make_h_matvec(tr, jnp.asarray(f), 0.1, N), b, tol=1e-7,
                    max_iters=300).x
    close(out[0]["cg"], want, 1e-3)
    assert out[0]["fixed_iters"] == 64
    close(out[0]["fixed"], want, 1e-2)


def test_chunked_sharded_cg_matches_materialised(ranks):
    _, _, out = ranks
    for r in out:
        close(r["chunked"], out[0]["cg"], 1e-5)


def test_strategy_resolution_auto_and_nystrom(ranks):
    """"auto" resolves to Jacobi (the same solve as the default); "nystrom"
    raises, since the pivot cross-block spans ranks."""
    _, _, out = ranks
    close(out[0]["auto"], out[0]["cg"], 1e-6)
    assert "row-sharded path" in out[0]["nystrom"], out[0]["nystrom"]


def test_compress_matches_jax_psum_reduce(ranks):
    """compress=True sums bf16-rounded partials in f32, as JAX's
    psum_reduce(compress=True) does (XLA upcasts the bf16 operand before
    the all-reduce); JAX's hook is run on a one-device mesh per partial,
    and the four results summed in f32.  Without compress the sum is of
    the f32 partials, which the compressed one is not."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.distributed import gp_shard as jshard

    _, _, out = ranks
    mesh = jax.make_mesh((1,), ("data",))
    hook = jshard.shard_map_compat(
        lambda p: jshard.psum_reduce(("data",), compress=True)(p),
        mesh=mesh, in_specs=P(), out_specs=P())
    parts = [np.asarray(hook(_partial(r).numpy())) for r in range(RANKS)]
    want = np.sum(np.stack(parts), axis=0, dtype=np.float32)
    plain = np.sum(np.stack([_partial(r).numpy() for r in range(RANKS)]), axis=0,
                   dtype=np.float32)
    for r in out:
        close(r["compress"], want, 1e-6)
        close(r["plain_reduce"], plain, 1e-6)
    assert not np.array_equal(out[0]["compress"].numpy(), out[0]["plain_reduce"].numpy())


def test_sharded_posterior_sample_is_finite_and_respects_the_mask(ranks):
    """Shape [N] and finite (the JAX test's check); the same sample on every
    rank and on a 1-rank mesh (the draws do not depend on the rank count);
    and values at unobserved rows of y change nothing (the mask)."""
    _, _, out = ranks
    s = out[0]["sample"]
    assert s.shape == (N,) and bool(torch.isfinite(s).all())
    for r in out:
        assert torch.equal(r["sample"], s)
    close(s, out[0]["sample_1"], 1e-5)
    assert torch.equal(out[0]["sample_garbage"], s)


# --- on the card: world size 1 under NCCL ------------------------------------


@pytest.fixture
def nccl_mesh(tmp_path):
    """A 1-rank NCCL process group in this process and its serving mesh
    (one card runs world size 1: NCCL puts no two ranks on one card)."""
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


@pytest.mark.gpu
def test_gpu_sharded_solves_at_world_size_one(nccl_mesh):
    """The three sharded solvers on the card under NCCL: the sharded CG
    within 1e-4 of scale of the single-device solve (the fused K̂ kernel
    there, the ELL pair here), the chunked solve at chunk 1024 likewise, the
    posterior sample finite; the ELL kernels and the walk sampler (its vals
    entry: the chunked solve's walks) launched, the fused K̂ kernel never
    inside the sharded calls."""
    from repro_torch import solvers
    from repro_torch.core import linops, modulation, walks
    from repro_torch.distributed import gp_shard as G
    from repro_torch.graphs import generators
    from repro_torch.kernels import dispatch

    dev = torch.device("cuda", 0)
    seed = 1214163296
    g = generators.ring(4096, k=3, device=dev)
    tr = walks.sample_walks(g, seed, **CFG)
    mod = modulation.diffusion(l_max=CFG["l_max"])
    f = mod(mod.init(device=dev))
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32)).to(dev)
    want = solvers.solve(linops.shifted(tr, f, 0.1), b,
                         solvers.SolveStrategy(tol=1e-6, max_iters=500)).x
    dispatch.reset_launch_counts()
    got, iters, ok = G.sharded_cg_solve(tr, f, b, nccl_mesh, sigma_n2=0.1, tol=1e-6,
                                        max_iters=500, return_diagnostics=True)
    assert bool(ok)
    close(got.cpu(), want.cpu(), 1e-4)
    ck = G.sharded_cg_solve_chunked(g, f, b, nccl_mesh, seed, walks.WalkConfig(**CFG),
                                    chunk=1024, sigma_n2=0.1, tol=1e-6, max_iters=500)
    close(ck.cpu(), want.cpu(), 1e-4)
    mask = (torch.arange(4096, device=dev) < 512).float()
    s = G.sharded_posterior_sample(tr, mask, f, mask * b, torch.Generator(device=dev)
                                   .manual_seed(5), nccl_mesh, sigma_n2=0.05)
    assert s.shape == (4096,) and bool(torch.isfinite(s).all())
    counts = dispatch.launch_counts()
    for name in ("ell_spmv", "ell_spmv_t", "walk_sampler_vals"):
        assert counts[name] > 0, name
    assert counts["khat_fused"] == 0
