"""PyTorch port, flash attention: the plain versions (``mha_ref``,
``mha_chunked_ref``) against the JAX Pallas kernel (interpret mode) and the
JAX oracle on the JAX kernel tests' nine cases, a bf16 case and a q_offset
case; the dispatcher's rules; and (marked ``gpu``) the CUDA kernel against
the plain version on the card at the same cases and at every head dim the
configs use.

Also the design of the tensor-core instance in plain PyTorch (an online
softmax over KV blocks in the log2 domain with P rounded to bf16 before P·V
and l summed from the rounded P) against the JAX kernel on bf16 inputs, and
the wrapper's routing rule between the two instances as a pure function.

Tolerances, relative to the result's scale: float32 2e-5 (the JAX kernel
test's: a softmax over ≤ 256 keys summed in another order); bf16 5e-2
against JAX (as the JAX test: both round q, k, v and o to bf16), and on the
card 2 bf16 ulps of the scale (the kernel and the plain version both compute
in float32 and round once; the tensor-core instance also rounds P to bf16,
as the TPU's MXU does at default precision).  The bf16-P design against the
JAX kernel: 2 bf16 ulps of the scale, the card's own gate.
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


def online_bf16_p(q, k, v, *, causal=True, window=None, softcap=None,
                  block_k=64):
    """The tensor-core instance's arithmetic in plain PyTorch: S = Q·Kᵀ in
    float32 over KV blocks, an online softmax in the log2 domain with the
    scale folded into the exponent, P rounded to bf16 before P·V and the
    row sum l taken from the rounded P, a row that sees no key 0."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    log2e = 1.4426950408889634
    sm = 1.0 / math.sqrt(d)
    e_mul = 1.0 if softcap else sm * log2e
    qf = q.float().reshape(b, hkv, g, sq, d)
    m = torch.full((b, hkv, g, sq), ref.NEG_INF)
    l = torch.zeros((b, hkv, g, sq))
    acc = torch.zeros((b, hkv, g, sq, d))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, skv, block_k):
        kc = k[:, :, k0:k0 + block_k].float()
        vc = v[:, :, k0:k0 + block_k].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kc)
        if softcap:
            s = softcap * log2e * torch.tanh(s * (sm / softcap))
        kpos = k0 + torch.arange(kc.shape[2])[None, :]
        mask = torch.ones((sq, kc.shape[2]), dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = s.masked_fill(~mask, ref.NEG_INF)
        tile = s.amax(-1)
        m_new = torch.maximum(m, torch.where(tile == ref.NEG_INF, tile, tile * e_mul))
        mu = torch.where(m_new == ref.NEG_INF, torch.zeros_like(m_new), m_new)
        p = torch.exp2(s * e_mul - mu[..., None]).to(torch.bfloat16).float()
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vc)
        m = m_new
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / safe[..., None]).reshape(b, h, sq, d).to(q.dtype)


@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("d", [80, 144])
def test_bf16_p_design_matches_jax(jx, d, window, softcap):
    """Rounding P to bf16 (the tensor-core instance's design) keeps the
    card's 2-ulp gate against the JAX kernel on bf16 inputs, at small
    danube-like (80) and gemma2-like (144) shapes: H = 4 over one KV head,
    S = 300 (not a multiple of the tile)."""
    jnp, jflash, _, _ = jx
    q, k, v = _inputs((1, 4, 1, 300, 300, d), seed=d)
    kw = dict(causal=True, window=window, softcap=softcap)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jflash(jq, jk, jv, interpret=True, block_q=64, block_k=64,
                             **kw), np.float32)
    tq, tk, tv = (_t(a, dtype=torch.bfloat16) for a in (q, k, v))
    got = online_bf16_p(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16
    bf16_close(got, want)
    bf16_close(got, ref.mha_ref(tq, tk, tv, **kw))


# The head dims of the configs: danube 80, whisper 64, zamba2 112, llama /
# moonshot / deepseek 128, gemma2 144, gemma3-12b 240, gemma3-4b 320, the
# reduced configs 16; and the JAX tests' 32.
CONFIG_HEAD_DIMS = [16, 32, 64, 80, 112, 128, 144, 240, 320]


@pytest.mark.parametrize("d", CONFIG_HEAD_DIMS)
def test_route_rule(d):
    """bf16, D a multiple of 8 up to 256 and aligned: the tensor cores;
    float32, D = 320 or a misaligned view: the CUDA cores."""
    tc = d <= 256
    assert ops.route(torch.bfloat16, d, True) == (
        ops.TENSOR_CORE if tc else ops.CUDA_CORE)
    assert ops.route(torch.bfloat16, d, False) == ops.CUDA_CORE
    assert ops.route(torch.float32, d, True) == ops.CUDA_CORE
    assert ops.route(torch.float32, d, False) == ops.CUDA_CORE


@pytest.mark.parametrize("d", [1, 24, 100, 250, 264, 319])
def test_route_rule_odd_head_dims(d):
    """Head dims that are not a multiple of 8, or past 256, take the CUDA
    cores; dims outside 1..320 raise."""
    want = ops.TENSOR_CORE if d % 8 == 0 and d <= 256 else ops.CUDA_CORE
    assert ops.route(torch.bfloat16, d, True) == want
    for bad in (0, 321, 336):
        with pytest.raises(ValueError, match="head dim"):
            ops.route(torch.bfloat16, bad, True)


def test_alignment_rule():
    """16-byte bases and batch/head/sequence strides in multiples of 8
    elements; a stride of a dimension of length 1 does not count."""
    base = torch.zeros((2, 40, 4, 88), dtype=torch.bfloat16)
    q = base.transpose(1, 2)[..., :80]                 # [2, 4, 40, 80] view
    assert ops.aligned(q, q.contiguous())
    assert not ops.aligned(base.transpose(1, 2)[..., 1:81])   # base 2 bytes off
    odd = torch.zeros((1, 4, 40, 84), dtype=torch.bfloat16)[..., :80]
    assert not ops.aligned(odd)                       # row stride 84
    one = torch.zeros((1, 1, 1, 80), dtype=torch.bfloat16)
    assert ops.aligned(one.as_strided((1, 1, 1, 80), (3, 5, 7, 1)))
    assert set(ops.LAUNCHES) == {"flash_attention", ops.TENSOR_CORE, ops.CUDA_CORE}


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

def _card_case(cuda, shape, kw, dtype, qkv=None):
    """One call on the card against mha_ref; the launch went to the
    instance the rule names (the tensor cores for bf16 with D a multiple of
    8 up to 256 when aligned)."""
    q, k, v = (_t(a, cuda, dtype) for a in _inputs(shape)) if qkv is None else qkv
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    d = shape[-1]
    tc = dtype == torch.bfloat16 and d % 8 == 0 and d <= 256 and ops.aligned(q, k, v)
    inst = ops.TENSOR_CORE if tc else ops.CUDA_CORE
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert ops.LAUNCHES[inst] == before[inst] + 1
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


@pytest.mark.gpu
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 112, 128, 144, 240, 256])
def test_gpu_tensor_core_head_dims_and_groups(cuda, d, group):
    """The tensor-core instance at every head dim it takes and GQA groups of
    1, 2, 4 and 8: causal with window and softcap at Sq = 77, cross
    attention at Sq = 200 over Skv = 333, plain causal at S = 300 (none a
    multiple of the 128-row or 64-key tile)."""
    hkv = 8 // group
    for shape, kw in (((1, 8, hkv, 77, 77, d), dict(window=40, softcap=50.0)),
                      ((2, 8, hkv, 200, 333, d), dict(causal=False)),
                      ((1, 8, hkv, 300, 300, d), {})):
        _card_case(cuda, shape, kw, torch.bfloat16)


@pytest.mark.gpu
def test_gpu_tensor_core_reads_strided_views(cuda):
    """bf16 q, k, v as transposed views of [B, S, H, D] projections (the LM
    path's layout) take the tensor cores without a copy."""
    rng = np.random.default_rng(13)
    q, k, v = (_t(rng.standard_normal((2, 150, n, 80)).astype(np.float32), cuda,
                  torch.bfloat16).transpose(1, 2) for n in (8, 2, 2))
    _card_case(cuda, (2, 8, 2, 150, 150, 80), dict(window=64), torch.bfloat16,
               qkv=(q, k, v))


@pytest.mark.gpu
def test_gpu_misaligned_views_take_cuda_cores(cuda):
    """A head-dim slice 2 bytes off a 16-byte base, or a row stride that is
    not a multiple of 8, routes bf16 to the CUDA-core instance, which gets
    it right."""
    rng = np.random.default_rng(14)
    base = [_t(rng.standard_normal((1, 4, 90, 96)).astype(np.float32), cuda,
               torch.bfloat16) for _ in range(3)]
    views = tuple(t[..., 1:81] for t in base)
    assert not ops.aligned(*views)
    _card_case(cuda, (1, 4, 4, 90, 90, 80), {}, torch.bfloat16, qkv=views)
    odd = tuple(_t(rng.standard_normal((1, 2, 50, 84)).astype(np.float32), cuda,
                   torch.bfloat16)[..., :80] for _ in range(3))
    assert not ops.aligned(*odd)
    _card_case(cuda, (1, 2, 2, 50, 50, 80), dict(window=8), torch.bfloat16, qkv=odd)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_batch_heads_past_a_grid_dimension(cuda, dtype):
    """B·H = 2049·32 = 65568, past a grid dimension's 65535: f32 on the
    CUDA-core instance (B·H folded over grid.y and grid.z) and bf16 on the
    tensor cores (a 1-D grid), each against mha_ref."""
    _card_case(cuda, (2049, 32, 8, 16, 16, 64), {}, getattr(torch, dtype))


@pytest.fixture
def fake_card(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors: ``build.on_cuda`` says yes
    and ``launch`` is a stand-in that computes the plain version under
    ``no_grad`` (as the kernel's result has no graph) into the kernel's
    [B, Sq, H, D] memory layout, counting its calls."""
    calls = []

    def fake_launch(inst, q, k, v, *, causal, window, softcap, q_offset=0):
        calls.append(inst)
        with torch.no_grad():
            out = ref.mha_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                              q_offset=q_offset)
        return out.transpose(1, 2).contiguous().transpose(1, 2)

    monkeypatch.setattr(ops.build, "on_cuda", lambda name, *ts: True)
    monkeypatch.setattr(ops, "launch", fake_launch)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [CASES[1], CASES[4], CASES[5]])
def test_autograd_function_backward_is_the_plain_versions(fake_card, case, dtype):
    """On the CUDA branch with inputs that require grad, the forward is one
    kernel launch and the backward equals autograd through ``mha_ref``
    (exactly: the Function recomputes the same plain version); without
    grad the kernel is launched directly and the result has no graph."""
    shape, kw = _split(case)
    tdt = getattr(torch, dtype)
    qkv = [torch.from_numpy(a).to(tdt) for a in _inputs(shape)]
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (shape[0], shape[1], shape[3], shape[5])).astype(np.float32)).to(tdt)
    for need in ((True, True, True), (False, True, False)):
        ins = [t.clone().requires_grad_(n) for t, n in zip(qkv, need)]
        out = ops.flash_attention(*ins, **kw)
        assert type(out.grad_fn).__name__ == "_FlashFnBackward"
        out.backward(g)
        plain = [t.clone().requires_grad_(n) for t, n in zip(qkv, need)]
        ref.mha_ref(*plain, **kw).backward(g)
        for a, b, n in zip(ins, plain, need):
            assert (a.grad is None) == (not n)
            if n:
                assert torch.equal(a.grad, b.grad)
    assert len(fake_card) == 2
    with torch.no_grad():
        out = ops.flash_attention(*[t.requires_grad_(True) for t in qkv], **kw)
    assert out.grad_fn is None and len(fake_card) == 3
