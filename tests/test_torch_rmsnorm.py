"""PyTorch port, fused RMSNorm: the plain version and the wrapper on the CPU
against the JAX Pallas kernel (interpret mode) and oracle on the JAX kernel
tests' cases (the 3-D input included), the port's ``layers.rms_norm``
against the JAX ``models.layers.rms_norm``, and (marked ``gpu``) the CUDA
kernel against the plain version on the card.

Tolerances: float32 1e-6 of the result's scale (one row sum of ≤ 256
squares in another order, and rsqrt); bfloat16 1 ulp of each element (both
sides compute in float32 and round once) — 2 ulps of the scale on the card,
where rsqrtf may differ from rsqrt by 2 float32 ulps.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rmsnorm import ops, ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = 1e-6
CASES = [
    (8, 64, "float32"),
    (100, 256, "float32"),     # non-divisible rows (padding)
    (33, 128, "bfloat16"),
    (2 * 7 * 16, 96, "float32"),
]
# The LM path's shapes: danube's prefill rows (1024, 4608) and a decode
# batch of 4, at d_model 2560; and gemma2-27b's 4608, 5120 for the widest.
CARD_SHAPES = [(1024, 2560), (4608, 2560), (4, 2560), (1, 2560), (37, 4608),
               (3, 5120), (5, 7)]


def _np(x):
    return x.detach().to(torch.float32).cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def close(got, want, tol=TOL):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def within_ulps(got, want, ulps=1):
    """Elementwise: |got − want| ≤ ``ulps`` bf16 ulps of |want|."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    mag = np.maximum(np.abs(want), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= ulps * ulp)


def scale_ulps(got, want, ulps=2):
    """|got − want| ≤ ``ulps`` bf16 ulps of the result's scale."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    ulp = 2.0 ** (math.floor(math.log2(float(np.abs(want).max()))) - 7)
    assert float(np.abs(got - want).max()) <= ulps * ulp


def _inputs(m, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32))


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.rmsnorm import rmsnorm, rmsnorm_ref
    from repro.models import layers as jlayers

    return jnp, rmsnorm, rmsnorm_ref, jlayers


@pytest.fixture
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("m,d,dtype", CASES)
def test_plain_matches_jax_kernel(jx, m, d, dtype):
    jnp, jkernel, jref, _ = jx
    x, scale = _inputs(m, d, m + d)
    jx_ = jnp.asarray(x, dtype)
    want = np.asarray(jkernel(jx_, jnp.asarray(scale), interpret=True, block_m=32),
                      np.float32)
    oracle = np.asarray(jref(jx_, jnp.asarray(scale)), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    before = ops.LAUNCHES["rmsnorm"]
    for got in (ref.rmsnorm_ref(tx, torch.from_numpy(scale)),
                ops.apply(tx, torch.from_numpy(scale))):
        assert got.dtype == tx.dtype
        if dtype == "float32":
            close(got, want)
            close(got, oracle)
        else:
            within_ulps(got, want)
            within_ulps(got, oracle)
    assert ops.LAUNCHES["rmsnorm"] == before   # the CPU launches nothing


def test_3d_input(jx):
    jnp, jkernel, jref, _ = jx
    x = np.random.default_rng(0).standard_normal((2, 17, 64)).astype(np.float32)
    scale = np.zeros(64, np.float32)
    want = np.asarray(jkernel(jnp.asarray(x), jnp.asarray(scale), interpret=True))
    got = ops.apply(torch.from_numpy(x), torch.from_numpy(scale))
    assert got.shape == (2, 17, 64)
    close(got, want)
    close(got, np.asarray(jref(jnp.asarray(x), jnp.asarray(scale))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_rms_norm_matches_jax(jx, dtype):
    """The model's norm (every block's prologue and the final norm)."""
    jnp, _, _, jlayers = jx
    rng = np.random.default_rng(5)
    x = (3 * rng.standard_normal((2, 17, 160))).astype(np.float32)
    scale = (0.2 * rng.standard_normal(160)).astype(np.float32)
    want = np.asarray(jlayers.rms_norm(jnp.asarray(x, dtype), jnp.asarray(scale)),
                      np.float32)
    got = layers.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(scale))
    if dtype == "float32":
        close(got, want)
    else:
        within_ulps(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d", CARD_SHAPES + [(m, d) for m, d, _ in CASES])
def test_gpu_kernel_matches_plain(cuda, m, d, dtype):
    x, scale = _inputs(m, d, 7 * m + d)
    tx = torch.from_numpy(x).to(cuda).to(getattr(torch, dtype))
    ts = torch.from_numpy(scale).to(cuda)
    before = ops.LAUNCHES["rmsnorm"]
    got = ops.apply(tx, ts)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == before + 1
    want = ref.rmsnorm_ref(tx, ts)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        close(got, want)
    else:
        scale_ulps(got, want)


@pytest.mark.gpu
def test_gpu_kernel_3d_and_bad_inputs(cuda):
    x = torch.randn((2, 17, 64), device=cuda)
    s = torch.randn((64,), device=cuda)
    close(ops.apply(x, s), ref.rmsnorm_ref(x, s))
    with pytest.raises(ValueError, match="scale"):
        ops.apply(x, torch.zeros(63, device=cuda))
    with pytest.raises(TypeError):
        ops.apply(x.half(), s)
    with pytest.raises(ValueError):
        ops.apply(x, s.cpu())


# The configs' d_model widths (moonshot 2048, danube / gemma3-4b 2560,
# gemma3-12b 3840, llama-3.2-vision 4096, gemma2-27b 4608, deepseek 5120):
# the 16-byte instance's vector counts.
CONFIG_WIDTHS = [2048, 2560, 3840, 4096, 4608, 5120]


def _card_norm(cuda, x, s):
    before = ops.LAUNCHES["rmsnorm"]
    got = ops.apply(x, s)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == before + (1 if x.numel() else 0)
    want = ref.rmsnorm_ref(x, s)
    assert got.dtype == x.dtype and got.shape == x.shape
    if x.numel() == 0:
        return
    if x.dtype == torch.float32:
        close(got, want)
    else:
        scale_ulps(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", CONFIG_WIDTHS)
@pytest.mark.parametrize("m", [0, 1, 4, 4608])
def test_gpu_config_widths(cuda, m, d, dtype):
    """Every config width at a decode batch (1, 4), a prefill (4608) and no
    rows at all."""
    x, scale = _inputs(max(m, 1), d, 3 * m + d)
    tx = torch.from_numpy(x[:m]).to(cuda).to(getattr(torch, dtype))
    _card_norm(cuda, tx, torch.from_numpy(scale).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [7, 100, 2566, 12000])
def test_gpu_widths_off_the_vector(cuda, d, dtype):
    """Widths that are not a multiple of the 16-byte vector (7, 2566; 100
    in bf16) or too wide for it (12000) take the scalar instance."""
    x, scale = _inputs(37, d, d)
    tx = torch.from_numpy(x).to(cuda).to(getattr(torch, dtype))
    _card_norm(cuda, tx, torch.from_numpy(scale).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_unaligned_row_base(cuda, dtype):
    """A contiguous x whose base is one element off 16 bytes, and a scale
    that is a strided float64 view: the wrapper casts the scale, the kernel
    takes the scalar instance."""
    m, d = 9, 2560
    flat = torch.randn(1 + m * d, device=cuda).to(getattr(torch, dtype))
    x = flat[1:].view(m, d)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    s = (0.1 * torch.randn(2 * d, device=cuda, dtype=torch.float64))[::2]
    _card_norm(cuda, x, s)


@pytest.fixture
def fake_card(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors: ``build.on_cuda`` says yes
    and ``launch`` is a stand-in that computes the plain version under
    ``no_grad`` (the kernel's result has no graph), counting its calls."""
    calls = []

    def fake_launch(x, scale, eps):
        calls.append(tuple(x.shape))
        with torch.no_grad():
            return ref.rmsnorm_ref(x, scale, eps)

    monkeypatch.setattr(ops.build, "on_cuda", lambda name, *ts: True)
    monkeypatch.setattr(ops, "launch", fake_launch)
    return calls


@pytest.mark.parametrize("m, d, dtype", CASES)
def test_autograd_function_backward_is_the_plain_versions(fake_card, m, d, dtype):
    """On the CUDA branch with inputs that require grad, the forward is one
    kernel launch and the backward equals autograd through ``rmsnorm_ref``
    (exactly: the same plain version recomputed); without grad the kernel is
    launched directly and the result has no graph."""
    rng = np.random.default_rng(m + d)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(tdt)
    s = torch.from_numpy(0.1 * rng.standard_normal(d).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(tdt)
    for need in ((True, True), (False, True), (True, False)):
        ins = [t.clone().requires_grad_(n) for t, n in zip((x, s), need)]
        out = ops.apply(*ins, 1e-6)
        assert type(out.grad_fn).__name__ == "_RmsNormFnBackward"
        out.backward(g)
        plain = [t.clone().requires_grad_(n) for t, n in zip((x, s), need)]
        ref.rmsnorm_ref(*plain, 1e-6).backward(g)
        for a, b, n in zip(ins, plain, need):
            assert (a.grad is None) == (not n)
            if n:
                assert torch.equal(a.grad, b.grad)
    assert len(fake_card) == 3
    out = layers.rms_norm(x, s)          # nothing requires grad
    assert out.grad_fn is None and len(fake_card) == 4
