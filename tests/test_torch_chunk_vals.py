"""PyTorch port: the chunked Φ products' feature values written by the walk
sampler (``dispatch.walk_sample_vals``, ``walk_sample_vals_launch``).

With a float32 f that needs no gradient, each chunk's (cols, vals) comes
from the sampler's vals entry (one launch on the card, its plain version on
the CPU); otherwise (a bf16 f, an f under a gradient) it is composed from
the sampled (loads, lens) as before.  On the CPU: the entry's plain version
against the composition bit for bit, the choice of path, the gradient
through the composed path, and the ``walks.chunk_values`` counter.  Marked
``gpu``: the kernel's (cols, vals) against its plain version and against
the composition on the card, bit for bit, at the chunked products' shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import features, modulation, walks  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.walk_sampler import ops, ref  # noqa: E402

SEED = 2_147_483_659            # past 31 bits, as the benchmark's seeds are
TOL = 1e-5                      # autograd through the plain versions

# (graph, walkers, p_halt, l_max): the ring at the serving width (K = 144)
# and a k-NN sphere at the wind example's (K = 900).
GRAPHS = {
    "ring": (lambda n, dev: generators.ring(n, k=3, device=dev), 16, 0.1, 8),
    "sphere": (lambda n, dev: generators.knn_sphere(n, k=6, seed=0,
                                                    device=dev)[0], 100, 0.1, 8),
}


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= tol * scale


@pytest.fixture(autouse=True)
def clean_obs(monkeypatch):
    monkeypatch.delenv("REPRO_OBS", raising=False)
    obs.reset_enabled()
    obs.REGISTRY.reset()
    yield
    obs.reset_enabled()
    obs.REGISTRY.reset()


@pytest.fixture
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _modulation(l_max, dev="cpu"):
    mod = modulation.diffusion(l_max)
    return mod(mod.init(device=dev)).detach()


def _composed(g, nodes, f, n_valid, seed, kw):
    """The chunk's (cols, vals) as the composed path forms them."""
    cols, loads, lens = dispatch.walk_sample(g.neighbors, g.weights, g.deg,
                                             nodes, seed, **kw)
    valid = (torch.arange(nodes.shape[0], device=nodes.device)
             < n_valid).to(torch.float32)
    return cols, (loads * valid[:, None]).to(f.dtype) * f[lens]


def _chunk(g, chunk, n_valid):
    """The last chunk of the graph's rows, ``n_valid`` of them real, the rest
    clamped to the last node as the chunk loop pads."""
    start = g.n_nodes - n_valid
    idx = torch.arange(chunk, device=g.neighbors.device)
    return torch.clamp(start + idx, max=g.n_nodes - 1).to(torch.int32)


def _counter(name):
    return obs.REGISTRY.snapshot()["counters"].get(name, 0)


@pytest.mark.parametrize("graph", ["ring", "sphere"])
@pytest.mark.parametrize("n_valid", [96, 61], ids=["full", "padded"])
def test_plain_version_is_the_composition(graph, n_valid):
    make, walkers, p_halt, l_max = GRAPHS[graph]
    g = make(400, "cpu")
    kw = dict(n_walkers=walkers, p_halt=p_halt, l_max=l_max)
    f = _modulation(l_max)
    nodes = _chunk(g, 96, n_valid)
    cols, vals = ref.walk_sample_vals_ref(g.neighbors, g.weights, g.deg, nodes,
                                          f, n_valid, SEED, **kw)
    want_cols, want_vals = _composed(g, nodes, f, n_valid, SEED, kw)
    assert torch.equal(cols, want_cols) and torch.equal(vals, want_vals)
    assert vals.dtype == torch.float32
    assert bool((vals[n_valid:] == 0).all()) and bool((vals[:n_valid] != 0).any())


def test_wrapper_counts_its_own_launches_on_the_cpu():
    """On the CPU the entry runs its plain version and launches nothing;
    its obs taps are walk_sample's."""
    make, walkers, p_halt, l_max = GRAPHS["ring"]
    g = make(200, "cpu")
    nodes = _chunk(g, 64, 40)
    dispatch.reset_launch_counts()
    obs.enable()
    dispatch.walk_sample_vals(g.neighbors, g.weights, g.deg, nodes,
                              _modulation(l_max), 40, SEED, n_walkers=walkers,
                              p_halt=p_halt, l_max=l_max)
    counts = dispatch.launch_counts()
    assert counts["walk_sampler"] == counts["walk_sampler_vals"] == 0
    label = "{backend=cpu,scheme=iid}"
    assert _counter(f"walks.rows_sampled{label}") == 64
    assert _counter(f"walks.walkers_launched{label}") == 64 * walkers
    assert _counter(f"walks.sample_calls{label}") == 1


def test_wrapper_rejects_a_negative_count_and_an_unknown_scheme():
    make, walkers, p_halt, l_max = GRAPHS["ring"]
    g = make(200, "cpu")
    nodes = _chunk(g, 64, 40)
    kw = dict(n_walkers=walkers, p_halt=p_halt, l_max=l_max)
    with pytest.raises(ValueError, match="n_valid"):
        ops.walk_sample_vals(g.neighbors, g.weights, g.deg, nodes,
                             _modulation(l_max), -1, SEED, **kw)
    with pytest.raises(ValueError, match="unknown walk scheme"):
        ops.walk_sample_vals(g.neighbors, g.weights, g.deg, nodes,
                             _modulation(l_max), 40, SEED, **kw, scheme="x")


CFG = walks.WalkConfig(n_walkers=4, p_halt=0.3, l_max=3)
N, CHUNK = 250, 64          # four chunks, the last one partial


def _ring_problem():
    g = generators.ring(N, k=2, device="cpu")
    u = torch.randn(N, 3, generator=torch.Generator().manual_seed(0))
    return g, _modulation(CFG.l_max), u


def _chunk_paths():
    snap = obs.REGISTRY.snapshot()["counters"]
    return {p: snap.get(f"walks.chunk_values{{path={p}}}", 0)
            for p in ("sampler", "composed")}


@pytest.mark.parametrize("case", ["grad", "bf16", "bf16_grad"])
def test_composed_path_for_a_gradient_or_bf16(case):
    """An f under a gradient, or in bf16, takes the composed path, with the materialised trace's products; under a float32
    gradient, the materialised trace's gradient with respect to f (a bf16
    backward sums in bf16, in another order: values only)."""
    g, f0, u = _ring_problem()

    def modulation_of(leaf):
        return leaf.to(torch.bfloat16) if case.startswith("bf16") else leaf

    def leaf_of():
        return f0.clone().requires_grad_(case != "bf16")

    w = torch.randn(N, 3, generator=torch.Generator().manual_seed(1))
    leaf = leaf_of()
    obs.enable()
    y = features.phi_matvec_chunked(g, modulation_of(leaf), u, SEED, cfg=CFG,
                                    chunk=CHUNK)
    assert _chunk_paths() == {"sampler": 0, "composed": -(-N // CHUNK)}
    tr = walks.sample_walks(g, SEED, CFG.n_walkers, CFG.p_halt, CFG.l_max)
    leaf2 = leaf_of()
    y2 = features.phi_matvec(tr, modulation_of(leaf2), u)
    close(y.detach(), y2.detach())
    if case == "grad":
        (grad,) = torch.autograd.grad((y * w).sum(), leaf)
        (grad2,) = torch.autograd.grad((y2 * w).sum(), leaf2)
        close(grad, grad2)


@pytest.mark.parametrize("product", ["phi", "phi_t", "diag"])
def test_sampler_path_engages_and_gives_the_composed_values(product):
    """A float32 f without gradient takes the sampler's path,
    one ``walks.chunk_values{path=sampler}`` a chunk, with the composed
    path's results bit for bit."""
    g, f, u = _ring_problem()
    kw = dict(cfg=CFG, chunk=CHUNK)
    call = {"phi": lambda ff: features.phi_matvec_chunked(g, ff, u, SEED, **kw),
            "phi_t": lambda ff: features.phi_t_matvec_chunked(g, ff, u, SEED, **kw),
            "diag": lambda ff: features.khat_diag_approx_chunked(g, ff, SEED, **kw)}
    obs.enable()
    got = call[product](f)
    assert _chunk_paths() == {"sampler": -(-N // CHUNK), "composed": 0}
    obs.REGISTRY.reset()
    want = call[product](f.clone().requires_grad_()).detach()
    assert _chunk_paths() == {"sampler": 0, "composed": -(-N // CHUNK)}
    assert torch.equal(got, want)


def test_chunk_values_counts_nothing_when_disabled():
    g, f, u = _ring_problem()
    features.phi_matvec_chunked(g, f, u, SEED, cfg=CFG, chunk=CHUNK)
    assert _chunk_paths() == {"sampler": 0, "composed": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [7, 3_000_000_019])
@pytest.mark.parametrize("graph, n_nodes", [("ring", 200_000),
                                            ("sphere", 200_000)])
def test_gpu_sampler_values_equal_the_composition(cuda, graph, n_nodes, seed):
    """walk_sample_vals on the card against its plain version
    (walk_sample_vals_ref, on the card's tensors) and against the present
    composition (walk_sample, then (loads·valid)·f[lens]) bit for bit, at
    [65536, 144]
    (the ring) and [65536, 900] (the O1280 chunk, k-NN sphere), a full chunk
    and a padded last chunk; one walk_sampler_vals launch each, and the
    chunk loop takes it."""
    make, walkers, p_halt, l_max = GRAPHS[graph]
    g = make(n_nodes, cuda)
    kw = dict(n_walkers=walkers, p_halt=p_halt, l_max=l_max)
    f = _modulation(l_max, cuda)
    chunk = walks.DEFAULT_CHUNK
    for n_valid in (chunk, 40_001):
        nodes = _chunk(g, chunk, n_valid)
        dispatch.reset_launch_counts()
        cols, vals = dispatch.walk_sample_vals(g.neighbors, g.weights, g.deg,
                                               nodes, f, n_valid, seed, **kw)
        assert dispatch.launch_counts()["walk_sampler_vals"] == 1
        assert dispatch.launch_shapes()["walk_sampler"] == {
            (chunk, walkers * (l_max + 1)): 1}
        plain_cols, plain_vals = ref.walk_sample_vals_ref(
            g.neighbors, g.weights, g.deg, nodes, f, n_valid, seed, **kw)
        assert torch.equal(cols, plain_cols) and torch.equal(vals, plain_vals)
        del plain_cols, plain_vals
        want_cols, want_vals = _composed(g, nodes, f, n_valid, seed, kw)
        assert torch.equal(cols, want_cols) and torch.equal(vals, want_vals)
        assert bool((vals[n_valid:] == 0).all())
        del cols, vals, want_cols, want_vals
    obs.enable()
    cols, vals = features._sample_chunk_vals(
        g, f, seed, g.n_nodes - 40_001, chunk, 40_001,
        walks.WalkConfig(n_walkers=walkers, p_halt=p_halt, l_max=l_max))
    assert _chunk_paths() == {"sampler": 1, "composed": 0}
    assert torch.equal(vals, _composed(g, _chunk(g, chunk, 40_001), f, 40_001,
                                       seed, kw)[1])
