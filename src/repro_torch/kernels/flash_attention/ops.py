"""Wrapper of the flash attention CUDA kernel (csrc/flash_attention.cu) and
the attention dispatcher of the LM scaffold (port of
``repro/kernels/flash_attention/ops.py``).

:func:`flash_attention` runs the plain version (``mha_ref``) on CPU tensors
and launches the kernel on CUDA tensors — on PyTorch's current stream, after
checking device, dtype, shapes and the head dim's contiguity — or raises.
The kernel reads q, k and v through their strides (the head dim must be
contiguous) and writes its output as [B, Sq, H, D] memory, returned as the
[B, H, Sq, D] view, so that the output projection reads it without a copy.

Gradients: when grad mode is on and q, k or v requires grad, the call goes
through an autograd Function whose forward is the same kernel launch and
whose backward recomputes ``mha_ref`` under ``torch.enable_grad()`` and takes
``torch.autograd.grad`` of it (the JAX package has no backward kernel to
port; its training attention is ``mha_ref`` too).  The Function saves only
q, k and v; with nothing requiring grad the kernel is launched directly.

The kernel has two instances, and :func:`route` is the rule between them, a
function of the dtype, the head dim and the alignment alone (no variable or
argument selects one): bf16 with D a multiple of 8 up to 256 and every base
16-byte aligned and every stride (of a dimension longer than 1) a multiple
of 8 elements takes the tensor-core instance; float32 (whose parity needs
float32 products), other head dims up to 320, and misaligned bf16 views take
the CUDA-core one.  ``LAUNCHES`` counts every launch under
``flash_attention`` and, beside it, each instance's own.

``q_offset`` is the global position of q's first row: the causal and
window masks compare key position kp with query position i + q_offset, as
``mha_ref(q_offset=...)`` does.  At 0 the kernel computes what it computed
before the argument existed.

Sharded inputs: DTensor q, k, v (the LM under ``launch/sharding.py``'s
placements) run shard by shard through ``local_map``.  Per mesh dim, a q
sharded over the batch shards k/v the same way; over the heads, k/v are
sharded over theirs when the kv heads divide, else kept whole and each rank
slices the kv heads its q heads read; over the query sequence (the
sequence-parallel layout), k/v are replicated and each rank passes its
shard's global ``q_offset``; anything else is replicated first.  Each rank
then runs :func:`attention` on its local tensors — the kernel on the card,
the plain version on the CPU; k/v's gradients are partial sums over the
mesh dims that split q and not them.

:func:`attention` keeps the JAX signature (plus ``q_offset``).  Decode (Sq == 1) takes the dense
path on either device, as in the JAX package (memory-bound: one query row per
head).  Otherwise a CUDA tensor goes to the kernel whatever ``use_pallas``,
``impl`` or ``interpret`` say, and a CPU tensor to a plain version:
``impl="chunked"`` selects ``mha_chunked_ref`` (KV blocks of ``block_k``),
anything else ``mha_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import build
from .ref import mha_chunked_ref, mha_ref

TENSOR_CORE = "flash_attention_tensor_core"
CUDA_CORE = "flash_attention_cuda_core"
# Kernel launches since the last reset, in all and per instance
# (chip_smoke.py reads them).
LAUNCHES = {"flash_attention": 0, TENSOR_CORE: 0, CUDA_CORE: 0}

MAX_HEAD_DIM = 320     # flash_attention_max_head_dim() of the kernel
MAX_TC_HEAD_DIM = 256  # the tensor-core instance's widest compiled head dim

_X = (torch.float32, torch.bfloat16)
_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ARGS = ([_VP] * 4 + [_I] * 6 + [_LL] * 12
         + [_I, _I, _I, ctypes.c_float, ctypes.c_float, _I, _VP])
_TC_ARGS = _ARGS[:-2] + [_VP]
_ENTRY = {TENSOR_CORE: ("flash_attention_tc_launch", _TC_ARGS),
          CUDA_CORE: ("flash_attention_launch", _ARGS)}


def route(dtype, d: int, aligned: bool) -> str:
    """The instance that takes a call: ``TENSOR_CORE`` or ``CUDA_CORE``;
    raises for a head dim that neither takes.  ``aligned``: every base is
    16-byte aligned and every stride of a dimension longer than 1 is a
    multiple of 8 elements (:func:`aligned`)."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} is outside 1..{MAX_HEAD_DIM}")
    if dtype == torch.bfloat16 and d % 8 == 0 and d <= MAX_TC_HEAD_DIM and aligned:
        return TENSOR_CORE
    return CUDA_CORE


def aligned(*tensors) -> bool:
    """16-byte bases, and batch, head and sequence strides in multiples of 8
    elements (16 bytes of bf16) on every such dimension longer than 1: what
    16-byte copies of head-dim rows need."""
    for t in tensors:
        if t.data_ptr() % 16:
            return False
        for n, st in zip(t.shape[:3], t.stride()[:3]):
            if n > 1 and st % 8:
                return False
    return True


def _check(name, q, k, v):
    for t, n in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype not in _X:
            raise TypeError(f"{name}: {n} must be one of {_X}, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name}: {n} must be 4-D, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {n} must be contiguous in its head dim")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q, k, v differ in dtype "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit together")
    if h % k.shape[1] != 0:
        raise ValueError(f"{name}: {h} query heads are not a multiple of "
                         f"{k.shape[1]} kv heads")
    route(q.dtype, d, True)   # the head dim is one that an instance takes


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, q_offset: int = 0) -> torch.Tensor:
    """Attention of q [B, H, Sq, D] over k, v [B, Hkv, Skv, D] (GQA: kv head
    = q head // (H / Hkv)), q's row i at global position i + q_offset;
    float32 math, q's dtype out; a row that sees no key gives 0 on the
    card."""
    name = "flash_attention"
    if not build.on_cuda(name, q, k, v):
        return mha_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                       q_offset=q_offset)
    _check(name, q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be None or ≥ 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"{name}: softcap must be None or > 0, got {softcap}")
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset must be ≥ 0, got {q_offset}")
    inst = route(q.dtype, q.shape[3], aligned(q, k, v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashFn.apply(q, k, v, inst, causal, window, softcap, q_offset)
    return launch(inst, q, k, v, causal=causal, window=window, softcap=softcap,
                  q_offset=q_offset)


class _FlashFn(torch.autograd.Function):
    """The kernel's forward; the backward through the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, inst, causal, window, softcap, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      q_offset=q_offset)
        return launch(inst, q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            out = mha_ref(*ins, **ctx.kw)
            grads = iter(torch.autograd.grad(
                out, [t for t in ins if t.requires_grad], g))
        return (*(next(grads) if n else None for n in need),
                None, None, None, None, None)


def launch(inst: str, q, k, v, *, causal: bool, window, softcap, q_offset: int = 0):
    """Launch instance ``inst`` on CUDA tensors that :func:`flash_attention`
    has checked and routed (chip_smoke.py also times each instance through
    it); the tensor-core entry refuses what its rule excludes."""
    name = "flash_attention"
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    args = [build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
            b, h, hkv, sq, skv, d, *strides, int(causal), int(q_offset),
            0 if window is None else int(window),
            0.0 if softcap is None else float(softcap), 1.0 / math.sqrt(d)]
    if inst == CUDA_CORE:
        args.append(int(q.dtype == torch.bfloat16))
    dev = q.device
    fn = build.bind(name, *_ENTRY[inst])
    with build.device(dev):
        fn(*args, build.stream(dev))
    LAUNCHES[name] += 1
    LAUNCHES[inst] += 1
    return out


def attention(q, k, v, *, causal=True, window=None, softcap=None,
              use_pallas: bool = True, interpret: bool | None = None,
              impl: str | None = None, block_k: int = 1024, q_offset: int = 0):
    """Dispatch as the JAX ``ops.attention`` does, by device (see the module
    docstring); ``interpret`` has no meaning here and is accepted only for
    the signature's sake."""
    del interpret
    kw = dict(causal=causal, window=window, softcap=softcap)
    if build.is_dtensor(q):
        return _sharded(q, k, v, dict(kw, use_pallas=use_pallas, impl=impl,
                                      block_k=block_k))
    if q.shape[2] == 1:
        return mha_ref(q, k, v, q_offset=q_offset, **kw)
    if build.on_cuda("flash_attention", q, k, v):
        return flash_attention(q, k, v, q_offset=q_offset, **kw)
    if impl is None:
        impl = "pallas" if use_pallas else "ref"
    if impl == "chunked":
        return mha_chunked_ref(q, k, v, q_offset=q_offset, block_k=block_k, **kw)
    return mha_ref(q, k, v, q_offset=q_offset, **kw)


def _offset(t, dim: int) -> int:
    """The global index of the first element of ``t``'s local shard along
    ``dim`` (even shards, split over the mesh dims in order)."""
    mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
    chunk, off = t.shape[dim], 0
    for i, p in enumerate(t.placements):
        if p.is_shard(dim):
            chunk //= mesh.size(i)
            off += coord[i] * chunk
    return off


def _sharded(q, k, v, kw: dict):
    """:func:`attention` of DTensors, shard by shard (module docstring)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    h, hkv = q.shape[1], k.shape[1]
    # k/v stay whole over the heads unless every mesh dim that splits q's
    # heads splits the kv heads evenly too.
    kv_whole = any(p.is_shard(1) and hkv % mesh.size(i)
                   for i, p in enumerate(q.placements))
    qp, kvp = [], []
    for p in q.placements:
        if p.is_shard(0) or (p.is_shard(1) and not kv_whole):
            qp.append(p)
            kvp.append(p)
        elif p.is_shard(1) or p.is_shard(2):
            qp.append(p)
            kvp.append(Replicate())
        else:
            qp.append(Replicate())
            kvp.append(Replicate())
    q = q.redistribute(mesh, qp)
    k = k.redistribute(mesh, kvp)
    v = v.redistribute(mesh, kvp)
    q_offset = _offset(q, 2)
    hl, g = q.to_local().shape[1], h // hkv
    kv0 = _offset(q, 1) // g
    kv1 = (_offset(q, 1) + hl - 1) // g + 1
    if kv_whole and not (kv1 - kv0 == 1 or (kv1 - kv0) * g == hl):
        raise ValueError(f"attention: {hl} of {h} query heads a shard do not "
                         f"read a whole group of the {hkv} kv heads")

    def local(ql, kl, vl):
        if kv_whole:
            kl, vl = kl[:, kv0:kv1], vl[:, kv0:kv1]
        return attention(ql, kl, vl, q_offset=q_offset, **kw)

    kv_grad = build.grad_placements(tuple(kvp), tuple(qp))
    return local_map(local, out_placements=(tuple(qp),), device_mesh=mesh,
                     in_grad_placements=(tuple(qp), kv_grad, kv_grad))(q, k, v)
