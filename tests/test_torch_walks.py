"""PyTorch port, walk sampling: graphs, RNG and traces against the JAX package.

Both packages get the same graph arrays and the same uint32 walk seed (never
a PRNG key: the key-derived seed depends on the jax version).  The JAX side
runs its "xla" path under jit, as ``sample_walks`` does, plus one
pallas-interpret case.

Tolerances: cols and lens are integer results of the same uint32 hash and
are compared bit for bit; loads are compared to ≤1 ulp — the port repeats
the float32 multiplications XLA compiles the reference to (division by a
constant becomes multiplication by its reciprocal), so they agree exactly
here, and 1 ulp is the margin for a compiler that contracts differently.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.graphs import generators as jgen  # noqa: E402
from repro.kernels.walk_sampler import ref as jref  # noqa: E402
from repro.kernels.walk_sampler import rng as jrng  # noqa: E402
from repro.kernels.walk_sampler import walk_sample as jwalk_pallas  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import walks as twalks  # noqa: E402
from repro_torch.graphs import formats as tformats  # noqa: E402
from repro_torch.graphs import generators as tgen  # noqa: E402
from repro_torch.kernels.walk_sampler import ref as tref  # noqa: E402
from repro_torch.kernels.walk_sampler import rng as trng  # noqa: E402

SEED = 1214163296
SCHEMES = ("iid", "antithetic", "qmc", "grfspp")
CPU = "cpu"


def _jax_walks(g, nodes, seed, **kw):
    """The JAX reference as its "xla" backend runs it (jitted)."""
    fn = jax.jit(lambda nb, w, d, n, s: jref.walk_sample_ref(nb, w, d, n, s, **kw))
    out = fn(g.neighbors, g.weights, g.deg, jnp.asarray(nodes, jnp.int32),
             jnp.uint32(seed))
    return [np.asarray(a) for a in out]


def _torch_walks(g, nodes, seed, **kw):
    tg = interop.graph_from_numpy(g.neighbors, g.weights, g.deg, device=CPU)
    out = tref.walk_sample_ref(tg.neighbors, tg.weights, tg.deg,
                               torch.as_tensor(np.asarray(nodes, np.int32)),
                               seed, **kw)
    return [a.numpy() for a in out]


def _assert_trace_equal(t, j):
    np.testing.assert_array_equal(t[0], j[0])   # cols, bit-exact
    np.testing.assert_array_equal(t[2], j[2])   # lens, bit-exact
    np.testing.assert_array_max_ulp(t[1], j[1], maxulp=1)


@pytest.fixture(scope="module")
def grid100():
    return jgen.grid2d(10, 10)


@pytest.fixture(scope="module")
def isolated():
    """A 40-node ring with chords plus node 40, which has no edge."""
    from repro.graphs.formats import from_edges

    idx = np.arange(40)
    edges = np.concatenate([np.stack([idx, (idx + o) % 40], 1) for o in (1, 3)])
    return from_edges(edges, 41)


@pytest.mark.parametrize("name,args", [
    ("ring", (50, 3)),
    ("grid2d", (7, 9)),
    ("community_sbm", (120, 4, 0.2, 0.01)),
    ("knn_sphere", (80, 5)),
    ("barabasi_albert", (90, 3)),
])
def test_generators_match_jax_ell_arrays(name, args):
    j = getattr(jgen, name)(*args)
    t = getattr(tgen, name)(*args, device=CPU)
    if isinstance(j, tuple):
        np.testing.assert_array_equal(np.asarray(t[1]), np.asarray(j[1]))
        j, t = j[0], t[0]
    for a, b in ((t.neighbors, j.neighbors), (t.weights, j.weights),
                 (t.deg, j.deg)):
        assert a.dtype in (torch.int32, torch.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_dense_and_laplacian_match_jax():
    from repro.graphs import formats as jformats

    j = jgen.grid2d(4, 5)
    t = tgen.grid2d(4, 5, device=CPU)
    np.testing.assert_allclose(tformats.to_dense(t).numpy(),
                               np.asarray(jformats.to_dense(j)), rtol=0, atol=0)
    np.testing.assert_allclose(tformats.normalized_laplacian(t).numpy(),
                               np.asarray(jformats.normalized_laplacian(j)),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 7, SEED, 2**32 - 1])
def test_rng_hash_matches_jax(seed):
    nodes = np.arange(0, 2**31 - 1, 2**31 // 257, dtype=np.int64)[:257]
    walkers = np.arange(9)
    for ctr in (0, 1, 2 * 5 + 1):
        jb = np.asarray(jrng.counter_bits(jnp.uint32(seed),
                                          jnp.asarray(nodes[:, None], jnp.uint32),
                                          jnp.asarray(walkers[None, :], jnp.uint32),
                                          jnp.uint32(ctr)))
        tb = trng.counter_bits(seed, torch.as_tensor(nodes[:, None]),
                               torch.as_tensor(walkers[None, :]), ctr)
        np.testing.assert_array_equal(tb.numpy().astype(np.uint32), jb)
        for scheme in SCHEMES:
            ju = np.asarray(jrng.halt_uniform(
                jnp.uint32(seed), jnp.asarray(nodes[:, None], jnp.uint32),
                jnp.asarray(walkers[None, :], jnp.uint32), jnp.uint32(ctr),
                scheme=scheme))
            tu = trng.halt_uniform(seed, torch.as_tensor(nodes[:, None]),
                                   torch.as_tensor(walkers[None, :]), ctr,
                                   scheme=scheme)
            np.testing.assert_array_equal(tu.numpy(), ju)
    x = np.array([0, 1, 2, 3, 0x80000000, 0xFFFFFFFF, 12345678], np.uint32)
    np.testing.assert_array_equal(
        trng.bitrev32(torch.as_tensor(x.astype(np.int64))).numpy().astype(np.uint32),
        np.asarray(jrng.bitrev32(jnp.asarray(x))))


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("cfg", [
    dict(n_walkers=8, p_halt=0.2, l_max=5),
    dict(n_walkers=5, p_halt=0.5, l_max=3, reweight=False),
])
def test_walks_match_jax(grid100, scheme, cfg):
    nodes = np.arange(100)
    _assert_trace_equal(_torch_walks(grid100, nodes, SEED, scheme=scheme, **cfg),
                        _jax_walks(grid100, nodes, SEED, scheme=scheme, **cfg))


def test_loads_bit_equal_to_jitted_reference(grid100):
    """Stronger than the 1-ulp bound: XLA compiles the reference's division
    by (1 − p_halt) and by n_walkers into multiplications by the float32
    reciprocals, and the port computes exactly that, so the loads agree bit
    for bit with the jitted reference."""
    nodes = np.arange(100)
    for scheme in SCHEMES:
        kw = dict(n_walkers=5, p_halt=0.3, l_max=6, scheme=scheme)
        t = _torch_walks(grid100, nodes, 7, **kw)
        np.testing.assert_array_equal(t[1], _jax_walks(grid100, nodes, 7, **kw)[1])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_isolated_node_matches_jax(isolated, scheme):
    nodes = np.array([40, 0, 39, 40, 17])
    kw = dict(n_walkers=4, p_halt=0.3, l_max=4, scheme=scheme)
    t = _torch_walks(isolated, nodes, 99, **kw)
    _assert_trace_equal(t, _jax_walks(isolated, nodes, 99, **kw))
    # The degree-0 start deposits at step 0 only.
    assert np.all(t[1][0].reshape(4, 5)[:, 1:] == 0)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("n_walkers,l_max", [(1, 0), (3, 8), (16, 8), (1, 24)])
def test_kernel_tile_shapes_match_jax(isolated, scheme, n_walkers, l_max):
    """The shapes at the CUDA kernel's tile edges (one row, 31 and 33 rows,
    1..16 walkers, l_max 0..24: 25 steps is where a block shrinks below 256
    walks), a non-contiguous node list with the degree-0 node in it,
    reweight off: the plain version, which the kernel is held to bit for
    bit on the card, against the jitted JAX reference.  A node's walks
    depend on its id only, so the first m rows of the 33-row reference are
    the reference of m rows.  (Past ~60 steps without reweighting the loads
    reach float32's subnormals, which XLA's CPU code flushes to zero.)"""
    nodes = np.array([40, 7, 3, 39, 0, 40, 22, 11, 5, 30, 2, 19, 36, 1, 28, 9,
                      40, 13, 25, 34, 6, 17, 38, 4, 21, 10, 33, 15, 27, 8, 31,
                      12, 24])
    kw = dict(n_walkers=n_walkers, p_halt=0.15, l_max=l_max, reweight=False,
              scheme=scheme)
    j = _jax_walks(isolated, nodes, 4242, **kw)
    for m in (1, 31, 33):
        t = _torch_walks(isolated, nodes[:m], 4242, **kw)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b[:m])   # cols, loads, lens bit-equal
        assert np.all(t[1][0].reshape(n_walkers, l_max + 1)[:, 1:] == 0)


def test_pallas_interpret_walk_case(grid100):
    """One small case against the Pallas kernel itself (interpret mode)."""
    nodes = np.arange(3, 40)
    kw = dict(n_walkers=4, p_halt=0.25, l_max=3, scheme="qmc")
    out = jwalk_pallas(grid100.neighbors, grid100.weights, grid100.deg,
                       jnp.asarray(nodes, jnp.int32), jnp.uint32(SEED),
                       block_m=16, interpret=True, **kw)
    _assert_trace_equal(_torch_walks(grid100, nodes, SEED, **kw),
                        [np.asarray(a) for a in out])


def test_golden_checksums():
    """The JAX package's iid golden on grid2d(6,6), keyed on the uint32 seed."""
    g = tgen.grid2d(6, 6, device=CPU)
    tr = twalks.sample_walks(g, SEED, n_walkers=5, p_halt=0.2, l_max=3,
                             scheme="iid")
    assert zlib.crc32(tr.cols.numpy().tobytes()) == 1350745773
    assert zlib.crc32(tr.lens.numpy().tobytes()) == 1932814751
    assert abs(float(tr.loads.numpy().astype(np.float64).sum())
               - 144.5396891087) < 1e-4


@pytest.mark.parametrize("scheme", SCHEMES)
def test_chunked_equals_monolithic(scheme):
    g = tgen.grid2d(9, 11, device=CPU)
    cfg = twalks.WalkConfig(6, 0.2, 4, scheme=scheme)
    full = twalks.sample_walks(g, 4242, cfg.n_walkers, cfg.p_halt, cfg.l_max,
                               scheme=scheme)
    starts, parts = zip(*twalks.walk_chunks(g, 4242, cfg, chunk=17))
    assert starts == tuple(range(0, 99, 17))
    for field in ("cols", "loads", "lens"):
        assert torch.equal(torch.cat([getattr(p, field) for p in parts]),
                           getattr(full, field))


def test_subset_rows_equal_full_rows():
    g = tgen.grid2d(9, 11, device=CPU)
    full = twalks.sample_walks(g, 31337, 7, 0.15, 6, scheme="antithetic")
    rows = torch.tensor([98, 0, 5, 5, 63], dtype=torch.int32)
    sub = twalks.sample_walks_for_nodes(g, rows, 31337, 7, 0.15, 6,
                                        scheme="antithetic")
    for field in ("cols", "loads", "lens"):
        assert torch.equal(getattr(sub, field), getattr(full, field)[rows.long()])
    assert sub.n_nodes == 5 and sub.slots == 7 * 7
    with pytest.raises(ValueError, match="nodes must lie"):
        twalks.sample_walks_for_nodes(g, torch.tensor([0, 99]), 1, 2)


def test_walk_config_validation_and_seed():
    cfg = twalks.WalkConfig(n_walkers=3, l_max=4)
    assert cfg.slots == 15 and cfg.scheme == "iid"
    with pytest.raises(ValueError, match="unknown walk scheme"):
        twalks.WalkConfig(n_walkers=3, scheme="sobol")
    with pytest.raises(ValueError, match="unknown walk scheme"):
        tref.walk_sample_ref(torch.zeros((2, 1), dtype=torch.int32),
                             torch.zeros((2, 1)), torch.zeros(2, dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32), 0,
                             n_walkers=1, p_halt=0.1, l_max=1, scheme="sobol")
    seeds = {twalks.walk_seed(torch.Generator().manual_seed(s)) for s in range(20)}
    assert len(seeds) == 20 and all(0 <= s < 2**32 for s in seeds)
    assert (twalks.walk_seed(torch.Generator().manual_seed(5))
            == twalks.walk_seed(torch.Generator().manual_seed(5)))
