"""PyTorch port, flash attention's query offset (``q_offset``): a query
shard of a sequence-parallel layout attends from its global position.

On the CPU the plain versions: a shard of q at its offset gives exactly the
rows of the whole-sequence result (causal, windowed, softcapped, GQA; the
chunked version too), and the sharded wrapper of DTensor inputs passes each
shard its offset.  Marked ``gpu``: the kernel, both instances, against
``mha_ref(q_offset=...)`` (float32 2e-5 of scale, bf16 2 ulps, as
tests/test_torch_flash.py), and at q_offset = 0 bit for bit the call
without the argument.  This file imports no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

SHARD_CASES = [  # (b, h, hkv, s, d), kw, parts
    ((2, 4, 2, 64, 16), {}, 4),
    ((1, 8, 8, 96, 32), dict(window=20), 3),
    ((1, 3, 1, 64, 16), dict(window=33, softcap=30.0), 2),
    ((2, 2, 2, 40, 8), dict(causal=False), 5),
]


def _inputs(shape, seed, device="cpu", dtype=torch.float32):
    b, h, hkv, s, d = shape
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(x).astype(np.float32))
                 .to(device).to(dtype)
                 for x in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))


@pytest.mark.parametrize("case", range(len(SHARD_CASES)))
def test_plain_shards_at_their_offsets_are_the_whole_rows(case):
    shape, kw, parts = SHARD_CASES[case]
    q, k, v = _inputs(shape, case)
    full = ref.mha_ref(q, k, v, **kw)
    chunked = ref.mha_chunked_ref(q, k, v, block_k=16, **kw)
    sl = shape[3] // parts
    for r in range(parts):
        rows = slice(r * sl, (r + 1) * sl)
        got = ops.attention(q[:, :, rows], k, v, q_offset=r * sl, use_pallas=False, **kw)
        torch.testing.assert_close(got, full[:, :, rows], rtol=0, atol=1e-6)
        got = ref.mha_chunked_ref(q[:, :, rows], k, v, q_offset=r * sl, block_k=16, **kw)
        torch.testing.assert_close(got, chunked[:, :, rows], rtol=0, atol=1e-6)


def test_flash_attention_rejects_a_negative_offset():
    q, k, v = _inputs((1, 2, 2, 8, 8), 0)
    if torch.cuda.is_available():
        q, k, v = (t.cuda() for t in (q, k, v))
        with pytest.raises(ValueError, match="q_offset"):
            ops.flash_attention(q, k, v, q_offset=-1)
    else:   # the plain version takes any offset; the kernel's check is on the card
        assert ops.flash_attention(q, k, v, q_offset=-1).shape == q.shape


@pytest.fixture
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bf16_ulps(got, want):
    err = float((got.double() - want.double()).abs().max())
    return err / 2.0 ** (np.floor(np.log2(float(want.double().abs().max()))) - 7)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(SHARD_CASES)))
def test_gpu_kernel_at_an_offset_matches_plain(cuda, case, dtype):
    dt = getattr(torch, dtype)
    shape, kw, parts = SHARD_CASES[case]
    q, k, v = _inputs(shape, case, cuda, dt)
    sl = shape[3] // parts
    for r in range(parts):
        qr = q[:, :, r * sl:(r + 1) * sl]
        got = ops.flash_attention(qr, k, v, q_offset=r * sl, **kw)
        want = ref.mha_ref(qr, k, v, q_offset=r * sl, **kw)
        if dt == torch.float32:
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 2e-5 * scale
        else:
            assert _bf16_ulps(got, want) <= 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_kernel_at_offset_zero_is_the_call_without_it(cuda, dtype):
    """Both instances (d = 64: tensor cores in bf16; f32: CUDA cores)."""
    q, k, v = _inputs((1, 8, 4, 300, 64), 9, cuda, getattr(torch, dtype))
    for kw in ({}, dict(window=100), dict(causal=False, softcap=20.0)):
        assert torch.equal(ops.flash_attention(q, k, v, q_offset=0, **kw),
                           ops.flash_attention(q, k, v, **kw))
