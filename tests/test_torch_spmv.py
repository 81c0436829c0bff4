"""PyTorch port, ``ell_spmv`` (y = Φu): the routing rule of its CUDA
instances on the CPU, and (marked ``gpu``) the kernel against its plain
version on the card.

Each lane of the kernel sums its slots of a row (all of them, or a part
whose partial sums meet in a fixed butterfly) in slot order, with FMA,
skipping zero slots, so it is held to ``ell_spmv_ref`` within 1e-5 of the
result's scale (another order than the einsum's), and to itself bit for
bit over two calls (no atomics).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.ell_spmv import ops, ref  # noqa: E402

RTOL = ATOL = 1e-5


@pytest.fixture
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("r,aligned,want", [
    (1, True, (ops.SCALAR, 1, 4)),
    (2, True, (ops.SCALAR, 2, 2)),
    (3, True, (ops.SCALAR, 4, 1)),
    (4, True, (ops.VECTOR, 1, 4)),
    (4, False, (ops.SCALAR, 4, 1)),
    (8, True, (ops.VECTOR, 2, 2)),
    (12, True, (ops.VECTOR, 4, 1)),
    (16, True, (ops.VECTOR, 4, 1)),
    (16, False, (ops.SCALAR, 16, 1)),
    (17, True, (ops.SCALAR, 32, 1)),
    (64, True, (ops.VECTOR, 16, 1)),
    (64, False, (ops.SCALAR, 32, 1)),
    (128, True, (ops.VECTOR, 32, 1)),
    (1000, True, (ops.VECTOR, 32, 1)),
])
def test_route_rule(r, aligned, want):
    """R and alignment → instance, lanes covering a row of u (at most 32)
    and parts of a row's slots (at least 4 lanes a row): the vector
    instance needs R % 4 == 0 and aligned bases."""
    assert ops.route(r, aligned) == want


def test_route_refuses_empty_rows():
    with pytest.raises(ValueError, match="at least 1"):
        ops.route(0, True)


def test_aligned_sees_a_sliced_base():
    x = torch.zeros(64)
    assert ops.aligned(x, x[4:])
    assert not ops.aligned(x[1:])
    assert not ops.aligned(x, x[2:].view(31, 2))


# --------------------------------------------------------------------------
# On the card.
# --------------------------------------------------------------------------


def _check(got, want, again=None):
    scale = max(float(want.abs().max()), 1e-30) if want.numel() else 1.0
    torch.testing.assert_close(got / scale, want / scale, rtol=RTOL, atol=ATOL)
    if again is not None:
        assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 7, 48, 144])
@pytest.mark.parametrize("r", [None, 1, 2, 3, 4, 16, 17, 64])
def test_gpu_spmv_shapes_match_plain(cuda, r, k):
    """M in {0, 1, 33, 65537}: within 1e-5 of scale, two calls bit-equal,
    one launch counted under (M, K, R), none for M = 0."""
    rng = np.random.default_rng(k * 100 + (r or 0))
    n = 5003
    for m in (0, 1, 33, 65537):
        vals = rng.standard_normal((m, k)).astype(np.float32)
        vals[rng.random((m, k)) < 0.35] = 0.0
        cols = rng.integers(0, n, (m, k)).astype(np.int32)
        u = rng.standard_normal((n,) if r is None else (n, r)).astype(np.float32)
        tv, tc, tu = (torch.from_numpy(a).to(cuda) for a in (vals, cols, u))
        dispatch.reset_launch_counts()
        got, again = ops.ell_spmv_raw(tv, tc, tu), ops.ell_spmv_raw(tv, tc, tu)
        assert got.shape == (m,) + tu.shape[1:]
        _check(got, ref.ell_spmv_ref(tv, tc, tu), again)
        calls = 2 if m else 0
        assert dispatch.launch_counts()["ell_spmv"] == calls
        assert dispatch.launch_shapes()["ell_spmv"] == (
            {(m, k, r or 1): 2} if m else {})


def _walk_payload(graph, dev, n_walkers=8, p_halt=0.2, l_max=5):
    from repro_torch.core import features, modulation, walks

    mod = modulation.diffusion(l_max)
    f = mod(mod.init(device=dev))
    tr = walks.sample_walks(graph, 2024, n_walkers, p_halt, l_max)
    return features.feature_values(tr, f).contiguous(), tr.cols.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ring", "barabasi_albert"])
@pytest.mark.parametrize("r", [None, 1, 16])
def test_gpu_spmv_walk_payloads_match_plain(cuda, kind, r):
    """Real walk payloads with halted walkers (zero slots on real columns):
    a ring (local gathers) and a preferential-attachment graph (scattered
    ones), at K = 48 and K = 144."""
    from repro_torch.graphs import generators

    n = 4000
    g = (generators.ring(n, k=3, device=cuda) if kind == "ring"
         else generators.barabasi_albert(n, m=3, seed=1, device=cuda))
    gen = torch.Generator(device=cuda).manual_seed(5)
    u = torch.randn((n,) if r is None else (n, r), generator=gen, device=cuda)
    for cfg in (dict(n_walkers=8, p_halt=0.2, l_max=5),
                dict(n_walkers=16, p_halt=0.1, l_max=8)):
        vals, cols = _walk_payload(g, cuda, **cfg)
        assert bool((vals == 0).any()), "no halted slots in the payload"
        got = ops.ell_spmv_raw(vals, cols, u)
        _check(got, ref.ell_spmv_ref(vals, cols, u), ops.ell_spmv_raw(vals, cols, u))


@pytest.mark.gpu
@pytest.mark.parametrize("r", [None, 4, 16])
def test_gpu_spmv_unaligned_bases_match_plain(cuda, r):
    """A u (or payload) whose base is not 16-byte aligned, a slice, takes
    the scalar instance (4-byte payload loads) and still matches."""
    rng = np.random.default_rng(9)
    m, k, n = 1000, 48, 777
    width = 1 if r is None else r
    vals = rng.standard_normal((m, k)).astype(np.float32)
    vals[rng.random((m, k)) < 0.3] = 0.0
    cols = rng.integers(0, n, (m, k)).astype(np.int32)
    flat = torch.from_numpy(rng.standard_normal(n * width + 1).astype(np.float32)).to(cuda)
    u = flat[1:] if r is None else flat[1:].view(n, r)
    assert u.is_contiguous() and not ops.aligned(u)
    assert ops.route(width, ops.aligned(u))[0] == ops.SCALAR
    tv, tc = torch.from_numpy(vals).to(cuda), torch.from_numpy(cols).to(cuda)
    _check(ops.ell_spmv_raw(tv, tc, u), ref.ell_spmv_ref(tv, tc, u),
           ops.ell_spmv_raw(tv, tc, u))
    # The payload sliced off its alignment: 4-byte loads.
    pv = torch.cat([torch.zeros(1, device=cuda), tv.reshape(-1)])[1:].view(m, k)
    pc = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda),
                    tc.reshape(-1)])[1:].view(m, k)
    assert not ops.aligned(pv, pc)
    _check(ops.ell_spmv_raw(pv, pc, u), ref.ell_spmv_ref(pv, pc, u))


@pytest.mark.gpu
def test_gpu_spmv_skips_zero_slots(cuda):
    """The one departure from the plain version: a non-finite u on a column
    that only zero slots reach is never read (0·inf is NaN in the plain
    version); one that a live slot reaches propagates as there."""
    vals = torch.tensor([[0.0, 2.0, -0.0, 1.0], [3.0, 0.0, 0.0, 0.0]], device=cuda)
    cols = torch.tensor([[0, 1, 0, 2], [0, 3, 3, 3]], dtype=torch.int32, device=cuda)
    u = torch.tensor([1.0, 2.0, 3.0, float("inf")], device=cuda)
    assert torch.equal(ops.ell_spmv_raw(vals, cols, u),
                       torch.tensor([7.0, 3.0], device=cuda))
    assert torch.isnan(ref.ell_spmv_ref(vals, cols, u)[1])
    u[0] = float("nan")
    got = ops.ell_spmv_raw(vals, cols, u)
    assert float(got[0]) == 7.0 and bool(torch.isnan(got[1]))
