"""PyTorch port, ELL kernels: plain versions against the JAX references, the
device dispatch rule, and (marked ``gpu``) each CUDA kernel against its plain
version on the card.

JAX is imported inside the tests that use it, so that the ``gpu`` tests also
collect on a machine with a card and no JAX.

Tolerances: the plain products sum the same float32 terms as the JAX
references in another order (einsum / index_add_ vs XLA's reductions), so
they agree to rtol = atol = 1e-5 at these sizes (K ≤ 64 terms of unit
scale); bf16 payloads are upcast exactly on both sides and held to the same
bound.  On the card, the scatter and the fused K̂ kernel add with float
atomics in a run-dependent order: 1e-5 of the result's scale.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, dispatch  # noqa: E402
from repro_torch.kernels.ell_spmv import ops, ref  # noqa: E402

RTOL = ATOL = 1e-5

# The shape sweeps of tests/test_kernels_ell.py.
CASES = [
    (16, 4, 16, None),
    (100, 33, 257, None),
    (512, 64, 1024, None),
    (256, 1, 64, None),
    (64, 16, 4096, None),
    (100, 33, 257, 5),
    (256, 16, 100, 3),
    (33, 7, 19, 2),
]
T_CASES = [
    (16, 4, 16, None),
    (100, 33, 257, None),
    (257, 16, 100, None),
    (100, 33, 257, 5),
    (33, 7, 19, 2),
    (512, 40, 2048, None),
    (512, 40, 2048, 3),
]
K_CASES = [
    (64, 64, 8, 8, 64, None),
    (100, 100, 33, 33, 100, 4),
    (300, 77, 8, 12, 257, None),
    (77, 300, 12, 8, 257, 3),
    (2048, 2048, 20, 20, 2048, None),
    (2048, 512, 20, 20, 2048, 2),
]


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


def _payload(rng, m, k, n, dup=False, zero_frac=0.0):
    vals = rng.standard_normal((m, k)).astype(np.float32)
    vals[rng.random((m, k)) < zero_frac] = 0.0
    cols = rng.integers(0, max(2, n // 50) if dup else n, (m, k)).astype(np.int32)
    return vals, cols


def _dense(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("m,k,n,r", CASES)
def test_spmv_plain_matches_jax(jx, m, k, n, r):
    jnp, jell = jx
    rng = np.random.default_rng(m * 1000 + k)
    vals, cols = _payload(rng, m, k, n)
    u = _dense(rng, (n,) if r is None else (n, r))
    want = np.asarray(jell.ell_spmv_ref(jnp.asarray(vals), jnp.asarray(cols),
                                        jnp.asarray(u)))
    got = ref.ell_spmv_ref(torch.from_numpy(vals), torch.from_numpy(cols),
                           torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m,k,n,r", T_CASES)
def test_spmv_t_plain_matches_jax(jx, m, k, n, r):
    jnp, jell = jx
    rng = np.random.default_rng(m * 1000 + k + n)
    vals, cols = _payload(rng, m, k, n)
    v = _dense(rng, (m,) if r is None else (m, r))
    want = np.asarray(jell.ell_spmv_t_ref(jnp.asarray(vals), jnp.asarray(cols),
                                          jnp.asarray(v), n))
    got = ref.ell_spmv_t_ref(torch.from_numpy(vals), torch.from_numpy(cols),
                             torch.from_numpy(v), n)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mg,ms,kg,ks,n,r", K_CASES)
def test_khat_plain_matches_jax(jx, mg, ms, kg, ks, n, r, dtype):
    jnp, jell = jx
    rng = np.random.default_rng(mg + ms * 7 + n)
    vg, cg = _payload(rng, mg, kg, n, dup=True)
    vs, cs = _payload(rng, ms, ks, n, zero_frac=0.3)
    v = _dense(rng, (ms,) if r is None else (ms, r))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jell.khat_matvec_ref(
        jnp.asarray(vg).astype(jd), jnp.asarray(cg), jnp.asarray(vs).astype(jd),
        jnp.asarray(cs), jnp.asarray(v), n))
    got = ref.khat_matvec_ref(
        torch.from_numpy(vg).to(td), torch.from_numpy(cg),
        torch.from_numpy(vs).to(td), torch.from_numpy(cs), torch.from_numpy(v), n)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kernel", ["ell_spmv", "ell_spmv_t", "khat_fused"])
def test_plain_matches_pallas_interpret(jx, kernel):
    """One small case per kernel against the Pallas kernel (interpret mode)."""
    jnp, jell = jx
    rng = np.random.default_rng(3)
    m, k, n, r = 45, 9, 70, 3
    vals, cols = _payload(rng, m, k, n, dup=True, zero_frac=0.2)
    tv, tc = torch.from_numpy(vals), torch.from_numpy(cols)
    jv, jc = jnp.asarray(vals), jnp.asarray(cols)
    if kernel == "ell_spmv":
        u = _dense(rng, (n, r))
        want = jell.ell_spmv(jv, jc, jnp.asarray(u), block_m=16, interpret=True)
        got = ops.ell_spmv(tv, tc, torch.from_numpy(u))
    elif kernel == "ell_spmv_t":
        v = _dense(rng, (m, r))
        want = jell.ell_spmv_t(jv, jc, jnp.asarray(v), n, block_m=16,
                               interpret=True)
        got = ops.ell_spmv_t(tv, tc, torch.from_numpy(v), n)
    else:
        v = _dense(rng, (m, r))
        want = jell.khat_matvec_fused(jv, jc, jv, jc, jnp.asarray(v), n,
                                      block_m=16, interpret=True)
        got = ops.khat_fused(tv, tc, tv, tc, torch.from_numpy(v), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_dispatch_on_cpu_runs_plain_versions():
    rng = np.random.default_rng(0)
    vals, cols = _payload(rng, 30, 6, 40)
    tv, tc = torch.from_numpy(vals), torch.from_numpy(cols)
    u, v = torch.from_numpy(_dense(rng, (40, 2))), torch.from_numpy(_dense(rng, (30,)))
    before = dispatch.launch_counts()
    assert torch.equal(dispatch.phi_matvec(tv, tc, u), ref.ell_spmv_ref(tv, tc, u))
    assert torch.equal(dispatch.phi_t_matvec(tv, tc, v, 40),
                       ref.ell_spmv_t_ref(tv, tc, v, 40))
    assert torch.equal(dispatch.khat_matvec(tv.bfloat16(), tc, tv.bfloat16(), tc, v, 40),
                       ref.khat_matvec_ref(tv.bfloat16(), tc, tv.bfloat16(), tc, v, 40))
    # The plain versions are not kernel launches.
    assert dispatch.launch_counts() == before


def test_mixed_devices_raise():
    """A wrapper never mixes devices (and never moves a tensor itself)."""
    cpu = torch.zeros((3, 2))
    meta = torch.zeros((3, 2), device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        build.on_cuda("ell_spmv", cpu, meta)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.ell_spmv(cpu, torch.zeros((3, 2), dtype=torch.int32), meta[:, 0])
    assert build.on_cuda("x", cpu, cpu[0]) is False


def test_launch_counters_reset():
    dispatch.reset_launch_counts()
    assert set(dispatch.launch_counts()) == {
        "walk_sampler", "ell_spmv", "ell_spmv_t", "khat_fused"}
    assert all(c == 0 for c in dispatch.launch_counts().values())


def test_cuda_sources_name_the_tpu_kernel_they_replace():
    """Each kernel source carries its note: the TPU kernel it replaces."""
    notes = {
        "walk_sampler": "src/repro/kernels/walk_sampler/walk_sampler.py:59",
        "ell_spmv": "src/repro/kernels/ell_spmv/ell_spmv.py:42",
        "ell_spmv_t": "src/repro/kernels/ell_spmv/ell_spmv_t.py:48",
        "khat_fused": "src/repro/kernels/ell_spmv/khat_fused.py:83",
    }
    assert set(build.SOURCES) == set(notes)
    for name, where in notes.items():
        text = (build.CSRC / f"{name}.cu").read_text()
        assert where in text and "What bounds it on this card" in text
        assert "torch/extension.h" not in text and "repro_cuda_error_string" in text


# --------------------------------------------------------------------------
# On the card: each kernel against its plain version.
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("r", [None, 3, 16])
def test_gpu_ell_kernels_match_plain(cuda, r):
    rng = np.random.default_rng(17)
    for (m, k, n) in [(1037, 48, 5003), (1, 7, 9), (300, 13, 40)]:
        for dup in (False, True):
            vals, cols = _payload(rng, m, k, n, dup=dup, zero_frac=0.3)
            tv, tc = torch.from_numpy(vals).to(cuda), torch.from_numpy(cols).to(cuda)
            u = torch.from_numpy(_dense(rng, (n,) if r is None else (n, r))).to(cuda)
            v = torch.from_numpy(_dense(rng, (m,) if r is None else (m, r))).to(cuda)
            pairs = [
                (ops.ell_spmv(tv, tc, u), ref.ell_spmv_ref(tv, tc, u)),
                (ops.ell_spmv_t(tv, tc, v, n), ref.ell_spmv_t_ref(tv, tc, v, n)),
            ]
            for dt in (torch.float32, torch.bfloat16):
                pv = tv.to(dt)
                pairs.append((ops.khat_fused(pv, tc, pv, tc, v, n),
                              ref.khat_matvec_ref(pv, tc, pv, tc, v, n)))
            for got, want in pairs:
                scale = max(float(want.abs().max()), 1e-30)
                torch.testing.assert_close(got / scale, want / scale,
                                           rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_gpu_khat_refuses_mixed_payload_dtypes(cuda):
    """One payload dtype per launch: a bf16 / f32 pair raises, never upcasts."""
    vals, cols = _payload(np.random.default_rng(5), 30, 6, 40)
    tv, tc = torch.from_numpy(vals).to(cuda), torch.from_numpy(cols).to(cuda)
    v = torch.ones((30,), device=cuda)
    before = dispatch.launch_counts()["khat_fused"]
    with pytest.raises(TypeError, match="differ"):
        ops.khat_fused(tv.bfloat16(), tc, tv, tc, v, 40)
    assert dispatch.launch_counts()["khat_fused"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["iid", "antithetic", "qmc", "grfspp"])
def test_gpu_walk_kernel_matches_plain(cuda, scheme):
    from repro_torch.graphs import formats
    from repro_torch.kernels.walk_sampler import ops as wops
    from repro_torch.kernels.walk_sampler import ref as wref

    idx = np.arange(500)
    edges = np.concatenate([np.stack([idx, (idx + o) % 500], 1) for o in (1, 4)])
    g = formats.from_edges(edges, 501, device=cuda)        # node 500 isolated
    nodes = torch.arange(501, dtype=torch.int32, device=cuda).flip(0)[:333]
    kw = dict(n_walkers=7, p_halt=0.2, l_max=5, scheme=scheme)
    before = dispatch.launch_counts()["walk_sampler"]
    got = wops.walk_sample(g.neighbors, g.weights, g.deg, nodes, 2**32 - 5, **kw)
    want = wref.walk_sample_ref(g.neighbors, g.weights, g.deg, nodes, 2**32 - 5, **kw)
    assert dispatch.launch_counts()["walk_sampler"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gpu_posterior_matches_cpu(cuda):
    """The slice end to end: kernels on the card vs plain versions on the CPU."""
    from repro_torch.core import modulation, walks
    from repro_torch.gp import posterior
    from repro_torch.graphs import generators

    out = {}
    for dev in (torch.device("cpu"), cuda):
        g = generators.ring(3000, k=3, device=dev)
        f = modulation.diffusion(5)(modulation.diffusion(5).init(device=dev))
        tr = walks.sample_walks(g, 77, 8, 0.2, 5)
        train = torch.arange(0, 3000, 37, dtype=torch.int32, device=dev)
        y = torch.sin(train.float() / 100.0)
        gen = torch.Generator().manual_seed(1)
        out[dev.type] = (
            posterior.posterior_mean(tr, train, f, 0.05, y),
            posterior.pathwise_samples(tr, train, f, 0.05, y, gen, n_samples=4),
        )
    for a, b in zip(out["cuda"], out["cpu"]):
        scale = float(b.abs().max())
        torch.testing.assert_close(a.cpu() / scale, b / scale, rtol=1e-3, atol=1e-3)
