"""PyTorch port, cross-Gram block: the plain versions and the autograd
Function against the JAX package, and (marked ``gpu``) the CUDA kernel
against its plain version on the card.

Payloads are ragged, with duplicate columns inside rows, zero-valued
padding slots and K_r ≠ K_c.  JAX runs its jnp oracle (``ref.py``) and its
Pallas kernel in interpret mode, as the JAX package's own tests do.

Tolerances: both sides sum the same float32 products (at most K_r·K_c per
entry, of unit scale) in another order: 1e-6 of the result's scale for the
plain versions.  The gradients pass through one more contraction (the
lookup): 1e-5 of scale.  On the card the kernel's sum order differs again:
1e-5 of scale, and two calls are bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.gram_block import ops, ref  # noqa: E402

PLAIN_TOL = 1e-6
GRAD_TOL = 1e-5
KERNEL_TOL = 1e-5

# (M_r, K_r, M_c, K_c, N): ragged, M_r = 1, K_r ≠ K_c, M_c past a 16-row tile.
SHAPES = [
    (23, 9, 17, 6, 80),
    (1, 12, 40, 12, 60),
    (33, 5, 7, 11, 30),
    (8, 16, 64, 16, 500),
]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.kernels import gram_block as jgram
    from repro.kernels.gram_block import ops as jops

    return jax, jnp, jgram, jops


@pytest.fixture
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def payload(rng, m, k, n, dup_frac=0.3):
    """Random ELL payload with duplicate columns inside rows and zero-valued
    padding slots (column 0, as the walk sampler pads)."""
    vals = rng.standard_normal((m, k)).astype(np.float32)
    cols = rng.integers(0, n, (m, k)).astype(np.int32)
    dup = rng.random((m, k)) < dup_frac
    cols[dup] = cols[:, :1].repeat(k, axis=1)[dup]
    pad = rng.random((m, k)) < 0.2
    vals[pad] = 0.0
    cols[pad] = 0
    return vals, cols


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def _case(shape, seed):
    m_r, k_r, m_c, k_c, n = shape
    rng = np.random.default_rng(seed)
    return payload(rng, m_r, k_r, n) + payload(rng, m_c, k_c, n)


@pytest.mark.parametrize("shape", SHAPES)
def test_gram_plain_matches_jax_ref_and_pallas(jx, shape):
    _, jnp, jgram, _ = jx
    vr, cr, vc, cc = _case(shape, sum(shape))
    want_ref = np.asarray(jgram.gram_block_ref(*map(jnp.asarray, (vr, cr, vc, cc))))
    want_pallas = np.asarray(jgram.gram_block(*map(jnp.asarray, (vr, cr, vc, cc)),
                                              interpret=True))
    got = ref.gram_block_ref(*map(torch.from_numpy, (vr, cr, vc, cc)))
    close(got, want_ref, PLAIN_TOL)
    close(got, want_pallas, PLAIN_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_gram_lookup_plain_matches_jax(jx, shape):
    _, jnp, jgram, _ = jx
    vr, cr, vc, cc = _case(shape, 7 + sum(shape))
    g = np.random.default_rng(3).standard_normal(
        (shape[0], shape[2])).astype(np.float32)
    want = np.asarray(jgram.gram_lookup_ref(jnp.asarray(g), jnp.asarray(vc),
                                            jnp.asarray(cc), jnp.asarray(cr)))
    got = ref.gram_lookup_ref(torch.from_numpy(g), torch.from_numpy(vc),
                              torch.from_numpy(cc), torch.from_numpy(cr))
    close(got, want, PLAIN_TOL)


def test_gram_ref_chunks_rows_like_one_block(monkeypatch):
    """The row chunking that bounds the compare block changes nothing but
    the einsum's summation order."""
    vr, cr, vc, cc = map(torch.from_numpy, _case((29, 7, 13, 9, 40), 5))
    whole = ref.gram_block_ref(vr, cr, vc, cc)
    look = ref.gram_lookup_ref(whole, vc, cc, cr)
    monkeypatch.setattr(ref, "_BLOCK_BYTES", 4 * 13 * 9 * 7 * 3)  # 3 rows
    assert ref._row_chunk(13, 9, 7) == 3
    close(ref.gram_block_ref(vr, cr, vc, cc), whole, PLAIN_TOL)
    close(ref.gram_lookup_ref(whole, vc, cc, cr), look, PLAIN_TOL)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_gram_autograd_matches_jax_vjp(jx, shape):
    """Both value cotangents of the port's Function == jax.vjp through
    gram_block_pallas(interpret=True)."""
    jax, jnp, _, jops = jx
    vr, cr, vc, cc = _case(shape, 11 + sum(shape))
    g = np.random.default_rng(5).standard_normal(
        (shape[0], shape[2])).astype(np.float32)
    jcr, jcc = jnp.asarray(cr), jnp.asarray(cc)
    y, vjp = jax.vjp(
        lambda a, b: jops.gram_block_pallas(a, jcr, b, jcc, interpret=True),
        jnp.asarray(vr), jnp.asarray(vc))
    want_r, want_c = vjp(jnp.asarray(g))
    tvr = torch.from_numpy(vr).requires_grad_()
    tvc = torch.from_numpy(vc).requires_grad_()
    out = ops.gram_block(tvr, torch.from_numpy(cr), tvc, torch.from_numpy(cc))
    d_r, d_c = torch.autograd.grad(out, (tvr, tvc), torch.from_numpy(g))
    close(out, y, PLAIN_TOL)
    close(d_r, want_r, GRAD_TOL)
    close(d_c, want_c, GRAD_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_gram_aggregation_twin_matches_jax(jx, shape):
    """The kernel's first step in plain PyTorch: each row as its distinct
    (column, Σ value) entries over the non-zero slots, in order of first
    occurrence; G from the aggregated rows equals the Pallas kernel's G on
    the raw payloads."""
    _, jnp, jgram, _ = jx
    vr, cr, vc, cc = _case(shape, 13 + sum(shape))
    want = np.asarray(jgram.gram_block(*map(jnp.asarray, (vr, cr, vc, cc)),
                                       interpret=True))
    agg_r = ref.aggregate_rows_ref(torch.from_numpy(vr), torch.from_numpy(cr))
    agg_c = ref.aggregate_rows_ref(torch.from_numpy(vc), torch.from_numpy(cc))
    for (ac, av, an), vals, cols in ((agg_r, vr, cr), (agg_c, vc, cc)):
        for i in range(vals.shape[0]):
            live = vals[i] != 0
            firsts = list(dict.fromkeys(cols[i][live].tolist()))
            n = int(an[i])
            assert ac[i, :n].tolist() == firsts
            assert bool((ac[i, n:] == -1).all()) and bool((av[i, n:] == 0).all())
            sums = [vals[i][live & (cols[i] == c)].astype(np.float64).sum()
                    for c in firsts]
            np.testing.assert_allclose(av[i, :n].numpy(), sums, rtol=1e-6, atol=1e-6)
    close(ref.gram_block_ref(agg_r[1], agg_r[0], agg_c[1], agg_c[0]), want,
          PLAIN_TOL)


@pytest.mark.parametrize("m,k,repeats", [(40, 33, 3), (12, 144, 16),
                                          (6, 900, 100)])
def test_aggregation_sums_match_an_order_free_sum(m, k, repeats):
    """``aggregate_rows_ref`` sums each column's slots in the CUDA kernel's
    order (chunks of 32, then the chunks); its sums agree with an
    order-free one, an einsum over the row's slots that share the column,
    within float32 tolerance, where a row's first column repeats
    ``repeats`` times (at K = 900, the wind example's step-0 column)."""
    rng = np.random.default_rng(m * k)
    vals, cols = payload(rng, m, k, 4 * k)
    cols[:, ::k // repeats] = cols[:, :1]
    tv, tc = torch.from_numpy(vals), torch.from_numpy(cols)
    ac, av, an = ref.aggregate_rows_ref(tv, tc)
    live = tv != 0
    same = (ac[:, :, None] == tc[:, None, :]) & live[:, None, :]
    want = torch.einsum("rab,rb->ra", same.to(torch.float32), tv)
    assert int(an.max()) < k
    close(av, want, PLAIN_TOL)


def test_gram_dispatch_cpu_is_plain_and_counts_nothing():
    vr, cr, vc, cc = map(torch.from_numpy, _case(SHAPES[0], 1))
    before = dispatch.launch_counts()["gram_block"]
    got = dispatch.gram_block(vr, cr, vc, cc)
    assert torch.equal(got, ref.gram_block_ref(vr, cr, vc, cc))
    assert dispatch.launch_counts()["gram_block"] == before


def test_gram_empty_and_shape_checks():
    vr, cr, vc, cc = map(torch.from_numpy, _case(SHAPES[0], 2))
    assert ops.gram_block_raw(vr[:0], cr[:0], vc, cc).shape == (0, vc.shape[0])
    assert ops.gram_block_raw(vr, cr, vc[:0], cc[:0]).shape == (vr.shape[0], 0)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.gram_block_raw(vr, cr, vc.to("meta"), cc)


# --------------------------------------------------------------------------
# On the card.
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES + [(1, 144, 128, 144, 5000),
                                            (512, 144, 512, 144, 10**6),
                                            (4000, 144, 1, 144, 10**6),
                                            (70, 200, 33, 150, 400)])
def test_gpu_gram_kernel_matches_plain(cuda, shape):
    """Against the plain version, and bit-equal to a second call (no
    atomics), at ragged shapes, a serving append, the Thompson q×q Gram and
    the Nyström pivot column."""
    vr, cr, vc, cc = (torch.from_numpy(a).to(cuda) for a in _case(shape, 3))
    before = ops.LAUNCHES["gram_block"]
    got = ops.gram_block_raw(vr, cr, vc, cc)
    again = ops.gram_block_raw(vr, cr, vc, cc)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gram_block"] == before + 2
    assert torch.equal(got, again)
    close(got, ref.gram_block_ref(vr, cr, vc, cc), KERNEL_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("m_r", [3, 40])
def test_gpu_gram_past_a_grid_dimension(cuda, m_r):
    """A side of 1 100 000 rows at K = 4: the kernel's grid has no limit on
    M_r or M_c, and either side may be the long one."""
    vr, cr, vc, cc = (torch.from_numpy(a).to(cuda)
                      for a in _case((m_r, 4, 1_100_000, 4, 50_000), 8))
    got = ops.gram_block_raw(vr, cr, vc, cc)
    close(got, ref.gram_block_ref(vr, cr, vc, cc), KERNEL_TOL)
    close(ops.gram_block_raw(vc, cc, vr, cr), got.T, KERNEL_TOL)


@pytest.mark.gpu
def test_gpu_gram_autograd_matches_plain(cuda):
    vr, cr, vc, cc = (torch.from_numpy(a).to(cuda) for a in _case(SHAPES[0], 4))
    a, b = vr.clone().requires_grad_(), vc.clone().requires_grad_()
    (ops.gram_block(a, cr, b, cc) ** 2).sum().backward()
    a2, b2 = vr.clone().requires_grad_(), vc.clone().requires_grad_()
    (ref.gram_block_ref(a2, cr, b2, cc) ** 2).sum().backward()
    close(a.grad, a2.grad, KERNEL_TOL)
    close(b.grad, b2.grad, KERNEL_TOL)


@pytest.mark.gpu
def test_gpu_gram_refuses_bad_inputs(cuda):
    vr, cr, vc, cc = (torch.from_numpy(a).to(cuda) for a in _case(SHAPES[0], 6))
    with pytest.raises(TypeError):
        ops.gram_block_raw(vr.double(), cr, vc, cc)
    with pytest.raises(ValueError, match="contiguous"):
        ops.gram_block_raw(vr.T.contiguous().T, cr, vc, cc)
    with pytest.raises(ValueError, match="differ"):
        ops.gram_block_raw(vr, cr[:, :3].contiguous(), vc, cc)
