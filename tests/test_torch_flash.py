"""PyTorch port, flash attention: the plain versions (``mha_ref``,
``mha_chunked_ref``) against the JAX Pallas kernel (interpret mode) and the
JAX oracle on the JAX kernel tests' nine cases, a bf16 case and a q_offset
case; the dispatcher's rules; and (marked ``gpu``) the CUDA kernel against
the plain version on the card at the same cases and at every head dim the
configs use.

Tolerances, relative to the result's scale: float32 2e-5 (the JAX kernel
test's: a softmax over ≤ 256 keys summed in another order); bf16 5e-2
against JAX (as the JAX test: both round q, k, v and o to bf16), and on the
card 2 bf16 ulps of the scale (the kernel and the plain version both compute
in float32 and round once).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

TOL = 2e-5
CASES = [
    dict(b=2, h=4, hkv=4, sq=128, skv=128, d=32),
    dict(b=1, h=8, hkv=2, sq=128, skv=128, d=32),               # GQA
    dict(b=1, h=4, hkv=2, sq=96, skv=96, d=32),                 # padding
    dict(b=1, h=2, hkv=2, sq=64, skv=64, d=32, causal=False),   # encoder
    dict(b=1, h=4, hkv=4, sq=128, skv=128, d=32, window=48),    # SWA
    dict(b=1, h=4, hkv=4, sq=128, skv=128, d=32, softcap=30.0), # gemma2
    dict(b=1, h=4, hkv=2, sq=128, skv=256, d=32, causal=False), # cross-attn
    dict(b=1, h=4, hkv=4, sq=128, skv=128, d=32, window=32, softcap=20.0),
    dict(b=1, h=2, hkv=1, sq=40, skv=40, d=16),                 # tiny + GQA
]
# Every head dim of the configs (danube 80, gemma3 320 / 240, gemma2 144,
# the reduced configs 16) and the JAX tests' 16 and 32, plus odd ones.
HEAD_DIMS = [16, 32, 64, 80, 112, 128, 144, 240, 320, 24, 100]


def _split(case):
    case = dict(case)
    shape = tuple(case.pop(k) for k in ("b", "h", "hkv", "sq", "skv", "d"))
    return shape, case


def _inputs(shape, dtype=np.float32, seed=None):
    b, h, hkv, sq, skv, d = shape
    rng = np.random.default_rng(b * 100 + h if seed is None else seed)
    q = rng.standard_normal((b, h, sq, d)).astype(dtype)
    k = rng.standard_normal((b, hkv, skv, d)).astype(dtype)
    v = rng.standard_normal((b, hkv, skv, d)).astype(dtype)
    return q, k, v


def _np(x):
    return x.detach().to(torch.float32).cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def close(got, want, tol=TOL):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def bf16_close(got, want, ulps=2):
    """|got − want| ≤ ``ulps`` bf16 ulps of the result's scale."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    assert float(np.abs(got - want).max()) <= ulps * ulp


def _t(a, dev="cpu", dtype=torch.float32):
    return torch.from_numpy(a).to(dev).to(dtype)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.flash_attention import flash_attention, mha_ref
    from repro.kernels.flash_attention.ref import mha_chunked_ref

    return jnp, flash_attention, mha_ref, mha_chunked_ref


@pytest.fixture
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", CASES)
def test_plain_versions_match_jax_kernel(jx, case):
    jnp, jflash, jref, _ = jx
    shape, kw = _split(case)
    q, k, v = _inputs(shape)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             interpret=True, block_q=32, block_k=64, **kw))
    oracle = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = ref.mha_ref(_t(q), _t(k), _t(v), **kw)
    close(got, want)
    close(got, oracle)
    close(ref.mha_chunked_ref(_t(q), _t(k), _t(v), block_k=48, **kw), want)
    # The wrapper takes the plain version on the CPU and launches nothing.
    before = ops.LAUNCHES["flash_attention"]
    close(ops.flash_attention(_t(q), _t(k), _t(v), **kw), want)
    assert ops.LAUNCHES["flash_attention"] == before


def test_bf16_matches_jax(jx):
    jnp, jflash, jref, _ = jx
    q, k, v = _inputs((1, 2, 2, 64, 64, 32), seed=0)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jflash(jq, jk, jv, interpret=True, block_q=32, block_k=32),
                      np.float32)
    tq, tk, tv = (_t(a, dtype=torch.bfloat16) for a in (q, k, v))
    got = ref.mha_ref(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    close(got, want, tol=5e-2)
    close(got, np.asarray(jref(jq, jk, jv), np.float32), tol=5e-2)


@pytest.mark.parametrize("window", [None, 24])
def test_q_offset_matches_jax(jx, window):
    """A prefill chunk: 16 queries at positions 48..63 over 64 keys."""
    jnp, _, jref, jchunked = jx
    q, k, v = _inputs((1, 4, 2, 16, 64, 32), seed=9)
    kw = dict(causal=True, window=window, q_offset=48)
    want = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    close(ref.mha_ref(_t(q), _t(k), _t(v), **kw), want)
    want_c = np.asarray(jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 block_k=16, **kw))
    close(ref.mha_chunked_ref(_t(q), _t(k), _t(v), block_k=16, **kw), want_c)


def test_dispatch_rules_on_cpu():
    """Sq == 1 takes the dense path; impl='chunked' selects mha_chunked_ref,
    anything else mha_ref; a row that sees no key averages in mha_ref and is
    0 in mha_chunked_ref (the kernel's rule), as in the JAX package."""
    q, k, v = (_t(a) for a in _inputs((1, 4, 2, 24, 24, 16), seed=3))
    for impl in (None, "ref", "pallas"):
        close(ops.attention(q, k, v, impl=impl, window=8),
              ref.mha_ref(q, k, v, window=8))
    close(ops.attention(q, k, v, impl="chunked", block_k=5, window=8),
          ref.mha_chunked_ref(q, k, v, block_k=5, window=8))
    close(ops.attention(q[:, :, :1], k, v, causal=False, impl="chunked"),
          ref.mha_ref(q[:, :, :1], k, v, causal=False))
    # Window 8 over 10 keys: rows 17.. see no key.
    q2 = _t(_inputs((1, 4, 2, 30, 24, 16), seed=4)[0])
    k2, v2 = k[:, :, :10], v[:, :, :10]
    dense = ref.mha_ref(q2, k2, v2, window=8)
    chunked = ref.mha_chunked_ref(q2, k2, v2, window=8, block_k=4)
    close(chunked[:, :, :17], dense[:, :, :17])
    assert float(chunked[:, :, 17:].abs().max()) == 0.0
    close(dense[:, :, 25], v2.mean(2).repeat_interleave(2, 1))


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

def _card_case(cuda, shape, kw, dtype):
    q, k, v = (_t(a, cuda, dtype) for a in _inputs(shape))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.mha_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        close(got, want)
    else:
        bf16_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_gpu_kernel_matches_plain(cuda, case, dtype):
    shape, kw = _split(case)
    _card_case(cuda, shape, kw, getattr(torch, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_gpu_kernel_every_head_dim(cuda, d):
    """Causal + window + softcap, GQA 2, ragged lengths, both dtypes; and a
    cross shape (Sq ≠ Skv, non-causal)."""
    for dtype in (torch.float32, torch.bfloat16):
        _card_case(cuda, (1, 4, 2, 77, 77, d), dict(window=40, softcap=50.0), dtype)
        _card_case(cuda, (2, 2, 1, 33, 150, d), dict(causal=False), dtype)


@pytest.mark.gpu
def test_gpu_kernel_reads_strided_inputs(cuda):
    """q as the transposed view of a [B, S, H, D] projection (no copy); the
    output is [B, Sq, H, D] memory seen as [B, H, Sq, D]."""
    rng = np.random.default_rng(12)
    qs = _t(rng.standard_normal((2, 70, 8, 80)).astype(np.float32), cuda)
    k = _t(rng.standard_normal((2, 4, 70, 80)).astype(np.float32), cuda)
    v = _t(rng.standard_normal((2, 70, 4, 80)).astype(np.float32), cuda).transpose(1, 2)
    q = qs.transpose(1, 2)
    got = ops.flash_attention(q, k, v, window=16)
    assert got.transpose(1, 2).is_contiguous()
    close(got, ref.mha_ref(q, k, v, window=16))


@pytest.mark.gpu
def test_gpu_kernel_refuses_bad_inputs(cuda):
    q, k, v = (_t(a, cuda) for a in _inputs((1, 2, 1, 8, 8, 336)))
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, v)
    q, k, v = (_t(a, cuda) for a in _inputs((1, 3, 2, 8, 8, 16)))
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, k, v)
    q, k, v = (_t(a, cuda) for a in _inputs((1, 2, 1, 8, 8, 16)))
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.cpu(), v)
