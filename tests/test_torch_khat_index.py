"""PyTorch port, the fused K̂ kernel's column index: the indexed algorithm's
plain version against the JAX Pallas kernel (interpret mode) and the port's
unfused plain version, the index's invariants, the walk trace's cache of
it, and (marked ``gpu``) the CUDA kernel through the index on the card.

Tolerances: the indexed plain version sums the same float32 products as the
references in another order (segment sums, then the gathers): 1e-5 of the
result's scale, bf16 payloads included (both sides upcast the same bf16
values exactly).  On the card the kernel sums in a third order: 1e-5 of
scale again; two calls of the kernel are compared bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.ell_spmv import index as kindex  # noqa: E402
from repro_torch.kernels.ell_spmv import ops, ref  # noqa: E402

TOL = 1e-5

# (M_r, K_r, M_c, K_c, N, R, row dtype, column dtype, kind).  kind "square":
# the column payload is the row payload; "rect": an independent row payload;
# "cross": row columns spread over all N nodes while the column payload
# touches only the first N/20, so most row slots meet no touched column.
CASES = [
    (45, 9, 45, 9, 70, None, "float32", "float32", "square"),
    (45, 9, 45, 9, 70, 3, "float32", "float32", "square"),
    (64, 48, 64, 48, 1000, 16, "float32", "float32", "square"),
    (100, 33, 37, 12, 257, 3, "float32", "float32", "rect"),
    (77, 20, 300, 8, 2048, None, "float32", "float32", "rect"),
    (64, 48, 64, 48, 1000, 16, "bfloat16", "bfloat16", "square"),
    (100, 33, 37, 12, 257, 3, "bfloat16", "float32", "rect"),
    (100, 33, 37, 12, 257, None, "float32", "bfloat16", "rect"),
    (500, 16, 40, 16, 4000, 16, "float32", "float32", "cross"),
    (500, 16, 40, 16, 4000, 1, "bfloat16", "bfloat16", "cross"),
    (30, 6, 0, 6, 40, 3, "float32", "float32", "rect"),
]


def _ids(case):
    mr, kr, mc, kc, n, r, dr, dc, kind = case
    return f"{kind}-{mr}x{kr}-{mc}x{kc}-R{r}-{dr}-{dc}"


@pytest.fixture(scope="module")
def jx():
    """The JAX references (skips where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ell_spmv as jell

    return jnp, jell


@pytest.fixture
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _payload(rng, m, k, hi, dup_frac=0.3, zero_frac=0.25):
    """Columns in [0, hi) with duplicates inside rows and zero-valued
    slots (whose columns stay, as a halted walker's do)."""
    vals = rng.standard_normal((m, k)).astype(np.float32)
    cols = rng.integers(0, max(hi, 1), (m, k)).astype(np.int32)
    if k:
        dup = rng.random((m, k)) < dup_frac
        cols[dup] = cols[:, :1].repeat(k, axis=1)[dup]
    vals[rng.random((m, k)) < zero_frac] = 0.0
    return vals, cols


def _case(case, seed=0):
    mr, kr, mc, kc, n, r, dr, dc, kind = case
    rng = np.random.default_rng(seed + mr + 7 * mc + n)
    vc, cc = _payload(rng, mc, kc, n // 20 if kind == "cross" else n)
    if kind == "square":
        vr, cr = vc, cc
    else:
        vr, cr = _payload(rng, mr, kr, n)
    v = rng.standard_normal((mc,) if r is None else (mc, r)).astype(np.float32)
    return vr, cr, vc, cc, v


def _torch(case, arrays, dev="cpu"):
    dr, dc = getattr(torch, case[6]), getattr(torch, case[7])
    vr, cr, vc, cc, v = (torch.from_numpy(a).to(dev) for a in arrays)
    return vr.to(dr), cr, vc.to(dc), cc, v


def close(got, want, tol=TOL):
    got = got.detach().double().cpu().numpy()
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_indexed_plain_matches_jax_and_unfused(jx, case):
    """The indexed algorithm (index, segment sums, mapped gather) computes
    the fused K̂ of the Pallas kernel and of the unfused plain version."""
    jnp, jell = jx
    arrays = _case(case)
    n = case[4]
    vr, cr, vc, cc, v = _torch(case, arrays)
    idx = kindex.column_index(cc, vc, n)
    got = ref.khat_matvec_indexed_ref(vr, cr, vc, idx, v)
    close(got, ref.khat_matvec_ref(vr, cr, vc, cc, v, n).numpy())
    if case[2] == 0:   # the Pallas kernel takes no empty column payload
        assert not got.any()
        return
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    want = jell.khat_matvec_fused(
        jnp.asarray(arrays[0]).astype(jd[case[6]]), jnp.asarray(arrays[1]),
        jnp.asarray(arrays[2]).astype(jd[case[7]]), jnp.asarray(arrays[3]),
        jnp.asarray(arrays[4]), n, block_m=16, interpret=True)
    close(got, np.asarray(want))


@pytest.mark.parametrize("case", CASES[:4] + CASES[8:], ids=_ids)
def test_column_index_invariants(case):
    """The compact ids cover exactly the columns of the non-zero slots; the
    segments partition the non-zero slots, each segment one column, in slot
    order."""
    vr, cr, vc, cc, v = _torch(case, _case(case, seed=1))
    n = case[4]
    idx = kindex.column_index(cc, vc, n)
    flat_c, flat_v = cc.reshape(-1).long(), vc.reshape(-1)
    nz = torch.nonzero(flat_v != 0).reshape(-1)
    touched = torch.unique(flat_c[nz])
    assert torch.equal(idx.uniq.long(), touched)
    assert idx.shape == tuple(cc.shape) and idx.n_nodes == n
    want_map = torch.full((n,), -1, dtype=torch.int32)
    want_map[touched] = torch.arange(len(touched), dtype=torch.int32)
    assert torch.equal(idx.node_map, want_map)
    order = idx.order.long()
    assert torch.equal(torch.sort(order).values, nz)          # a partition
    seg = idx.seg.long()
    assert seg[0] == 0 and seg[-1] == len(nz) and bool((seg[1:] > seg[:-1]).all())
    for u in range(idx.n_uniq):
        part = order[seg[u]:seg[u + 1]]
        assert bool((flat_c[part] == idx.uniq[u]).all())
        assert bool((part[1:] > part[:-1]).all())


@pytest.mark.parametrize("case", CASES[:4] + CASES[8:], ids=_ids)
def test_column_index_sized_by_a_known_count(case):
    """Given the number of non-zero weights, the index finds the same slots
    without reading their count back: the same index, field for field."""
    _, _, vc, cc, _ = _torch(case, _case(case, seed=2))
    n = case[4]
    want = kindex.column_index(cc, vc, n)
    got = kindex.column_index(cc, vc, n, nnz=int((vc != 0).sum()))
    for name in ("uniq", "order", "seg", "node_map"):
        assert torch.equal(getattr(got, name), getattr(want, name))
    assert got.shape == want.shape


def test_column_index_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="one 2-D shape"):
        kindex.column_index(torch.zeros((3, 4), dtype=torch.int32),
                            torch.ones((3, 5)), 10)


def test_trace_keeps_its_index_and_rebuilds_after_a_write():
    """WalkTrace.column_index is built once per trace and node count; it
    follows the loads (so it serves every modulation); an in-place write to
    the trace's columns gives a new index."""
    from repro_torch.core import features, linops, modulation, walks
    from repro_torch.graphs import generators

    g = generators.ring(300, k=2, device="cpu")
    tr = walks.sample_walks(g, 5, 4, 0.3, 3)
    idx = tr.column_index(300)
    assert tr.column_index(300) is idx
    assert tr.column_index(301) is not idx
    mod = modulation.diffusion(3)
    f = mod(mod.init(device="cpu"))
    vals = features.feature_values(tr, f)
    by_vals = kindex.column_index(tr.cols, vals, 300)
    assert torch.equal(idx.uniq, by_vals.uniq) and torch.equal(idx.order, by_vals.order)
    v = torch.randn((300, 2), generator=torch.Generator().manual_seed(0))
    close(ref.khat_matvec_indexed_ref(vals, tr.cols, vals, tr.column_index(300), v),
          linops.khat(tr, f, 300).matvec(v).numpy())
    tr.cols[0, 0] = (tr.cols[0, 0] + 1) % 300
    fresh = tr.column_index(300)
    assert fresh is not tr.column_index(301) and fresh is not idx
    assert torch.equal(fresh.uniq, kindex.column_index(tr.cols, tr.loads, 300).uniq)


def test_operator_products_unchanged_on_cpu():
    """KhatOperator and features.khat_matvec pass the trace's index; on the
    CPU the product is the plain version's, unchanged, and no launch."""
    from repro_torch.core import features, linops, modulation, walks
    from repro_torch.graphs import generators

    g = generators.ring(200, k=2, device="cpu")
    tr = walks.sample_walks(g, 9, 4, 0.3, 3)
    tx = features.take_rows(tr, torch.arange(0, 200, 7))
    mod = modulation.diffusion(3)
    f = mod(mod.init(device="cpu"))
    v = torch.randn((tx.cols.shape[0], 3), generator=torch.Generator().manual_seed(1))
    before = dispatch.launch_counts()["khat_fused"]
    vx = features.feature_values(tx, f)
    want = ref.khat_matvec_ref(vx, tx.cols, vx, tx.cols, v, 200)
    assert torch.equal(linops.khat(tx, f, 200).matvec(v), want)
    vt = features.feature_values(tr, f)
    w = torch.randn((200,), generator=torch.Generator().manual_seed(2))
    assert torch.equal(features.khat_matvec(tr, f, w),
                       ref.khat_matvec_ref(vt, tr.cols, vt, tr.cols, w, 200))
    assert dispatch.launch_counts()["khat_fused"] == before


# --------------------------------------------------------------------------
# On the card.
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_gpu_khat_through_index_matches_plain(cuda, case):
    """The kernel, with the index given and built by the wrapper, against
    the unfused plain version; the two calls are bit-equal."""
    vr, cr, vc, cc, v = _torch(case, _case(case), cuda)
    n = case[4]
    idx = kindex.column_index(cc, vc, n)
    before = ops.LAUNCHES["khat_fused"]
    got = ops.khat_fused_raw(vr, cr, vc, cc, v, n, idx)
    again = ops.khat_fused_raw(vr, cr, vc, cc, v, n)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["khat_fused"] == before + 2
    assert torch.equal(got, again)
    close(got, ref.khat_matvec_ref(vr, cr, vc, cc, v, n).cpu().numpy())


@pytest.mark.gpu
def test_gpu_khat_is_deterministic(cuda):
    """No atomics: two calls on a payload of few, much-repeated columns
    (≈100 slots on each) give bit-equal results, 1-D and R = 16."""
    rng = np.random.default_rng(21)
    vals, cols = _payload(rng, 4000, 144, 4000 // 20)
    tv, tc = torch.from_numpy(vals).to(cuda), torch.from_numpy(cols).to(cuda)
    idx = kindex.column_index(tc, tv, 10**6)
    for shape in ((4000,), (4000, 16)):
        v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
        a = ops.khat_fused_raw(tv, tc, tv, tc, v, 10**6, idx)
        b = ops.khat_fused_raw(tv, tc, tv, tc, v, 10**6, idx)
        assert torch.equal(a, b)
        close(a, ref.khat_matvec_ref(tv, tc, tv, tc, v, 10**6).cpu().numpy())


@pytest.mark.gpu
def test_gpu_khat_refuses_a_foreign_index(cuda):
    vr, cr, vc, cc, v = _torch(CASES[3], _case(CASES[3]), cuda)
    other = kindex.column_index(cr, vr, CASES[3][4])
    with pytest.raises(ValueError, match="index"):
        ops.khat_fused_raw(vr, cr, vc, cc, v, CASES[3][4], other)
    on_cpu = kindex.column_index(cc.cpu(), vc.cpu(), CASES[3][4])
    with pytest.raises(ValueError, match="index"):
        ops.khat_fused_raw(vr, cr, vc, cc, v, CASES[3][4], on_cpu)
