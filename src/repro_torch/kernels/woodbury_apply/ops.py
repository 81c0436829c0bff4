"""Wrapper of the Woodbury-apply CUDA kernel (csrc/woodbury_apply.cu) and
its autograd Function.

``woodbury_apply_raw`` runs the plain version (ref.py) on CPU tensors and
launches the kernel on CUDA tensors — on PyTorch's current stream, after
checking device, dtype, shape and contiguity — or raises.
:func:`woodbury_apply` wraps it in a ``torch.autograd.Function`` that mirrors
the JAX custom VJP (``repro/kernels/woodbury_apply/ops.py:27``).  The apply
is linear in ``v`` with the matrix D⁻¹ − D⁻¹B E⁻¹BᵀD⁻¹, so the cotangent of
``v`` re-runs the *same* kernel with E⁻ᵀ:

    d_v = woodbury_apply(b, dinv, einvᵀ, g),

and the payload cotangents (d_b, d_dinv, d_einv) come from autograd through
the plain version, as the JAX package takes them from its oracle's VJP.
Each is computed only when autograd asks for it.

A launch is two kernels, per-block partials of BᵀD⁻¹v and then clusters
of 16 blocks that sum them and expand.  :func:`plan` derives every launch
parameter, the scratch of the partials included, from the shape alone, so
a call does no host query beyond the launch.  A launch takes
:func:`launch_cols` columns of ``v`` at most; a wider ``v`` runs as several
launches writing into one output.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache

import torch

from .. import build
from .ref import woodbury_apply_ref

# Kernel launches since the last reset (chip_smoke.py reads it), and the
# same launches by (T, r, columns).
LAUNCHES = {"woodbury_apply": 0}
BY_SHAPE: Counter = Counter()

# The kernel's constants (csrc/woodbury_apply.cu).
THREADS = 512          # NT
BLOCKS = 16            # CLUSTER: blocks per cluster
MAX_COLS = 16          # MAX_CB: columns of v per launch
MAX_RANK = 8447
SMEM_FLOATS = 232448 // 4
PART_FLOATS = 8192     # an [r, columns] partial stays within 32 KB
ES_MAX = 8192          # floats of E⁻¹ rows a block keeps on chip
FULL_U = 256           # r·columns and E⁻¹ floats up to which every block
FULL_E = 16384         # forms all of u and s itself
MAX_PARTIALS = 64      # blocks of the partials launch
MAX_CLUSTERS = 8       # clusters of the expand launch
MAX_TILE = 32          # rows of B a block streams at a time

_F32 = (torch.float32,)
_VP = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_VP] * 6 + [ctypes.c_longlong] + [_I] * 9 + [_VP]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _r4(x: int) -> int:
    return (x + 3) & ~3


def _cbp(cb: int) -> int:
    return cb if cb <= 2 else _r4(cb)


def _ld(r: int) -> int:
    """Row stride of B on chip (the kernel's ``ld_of``)."""
    return r + 4 if r % 4 == 0 else r | 1


def _full(r: int, cb: int) -> bool:
    """Every block forms all of u and s itself (the kernel's ``full_mode``)."""
    return r * cb <= FULL_U and r * r <= FULL_E


def _layout_floats(rows: int, r: int, cb: int) -> int:
    """Shared floats of a block holding ``rows`` rows of B, w and D⁻¹
    (the kernel's ``layout``)."""
    p, js, full = _cbp(cb), _cdiv(r, BLOCKS), _full(r, cb)
    es = r * r if full else (js * r if js * r <= ES_MAX else 0)
    return (_r4(rows * _ld(r)) + _r4(rows * p) + _r4(rows) + _r4(r * p)
            + 2 * _r4(js * p) + _r4(max(js, THREADS) * p) + _r4(es)
            + (_r4(r * p) if full else 0))


def launch_cols(r: int) -> int:
    """Columns of ``v`` one launch takes at rank r."""
    return max(1, min(MAX_COLS, PART_FLOATS // r))


@lru_cache(maxsize=256)
def plan(t: int, r: int, cols: int) -> tuple:
    """(rows, tile, partials, clusters, expand rows, scratch floats) of one
    launch of ``cols`` ≤ :func:`launch_cols` columns: ``partials`` blocks of
    ``rows`` rows (at most MAX_PARTIALS, at least MAX_TILE rows each), B
    streamed in ``tile``-row tiles, one [r, columns] partial each in the
    scratch, then ``clusters`` clusters of 16 blocks expanding ``expand
    rows`` rows a block."""
    fixed = _layout_floats(0, r, cols)
    tile = min(MAX_TILE, (SMEM_FLOATS - fixed - 16) // (2 * (_ld(r) + _cbp(cols) + 1)))
    rows = max(MAX_TILE, _cdiv(t, MAX_PARTIALS))
    partials = _cdiv(t, rows)
    clusters = max(1, min(MAX_CLUSTERS, _cdiv(t, 1024)))
    return (rows, tile, partials, clusters, _cdiv(t, clusters * BLOCKS),
            partials * r * _cbp(cols))


def woodbury_apply_raw(b: torch.Tensor, dinv: torch.Tensor, einv: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """M⁻¹v: b f32[T, r], dinv f32[T], einv f32[r, r], v f32[T(, R)] →
    f32 of ``v``'s shape; on the card one launch per :func:`launch_cols`
    columns."""
    name = "woodbury_apply"
    if not build.on_cuda(name, b, dinv, einv, v):
        return woodbury_apply_ref(b, dinv, einv, v)
    build.check(name, b, "b", _F32, (2,))
    build.check(name, dinv, "dinv", _F32, (1,))
    build.check(name, einv, "einv", _F32, (2,))
    build.check(name, v, "v", _F32, (1, 2))
    t, r = b.shape
    if dinv.shape[0] != t or v.shape[0] != t:
        raise ValueError(f"{name}: b has {t} rows, dinv {dinv.shape[0]}, "
                         f"v {v.shape[0]}")
    if tuple(einv.shape) != (r, r):
        raise ValueError(f"{name}: einv {tuple(einv.shape)} is not [{r}, {r}]")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"{name}: the kernel does not take rank {r} "
                         f"(1..{MAX_RANK})")
    width = 1 if v.dim() == 1 else v.shape[1]
    out = torch.empty_like(v)
    if t == 0 or width == 0:
        return out
    fn = build.bind(name, "woodbury_apply_launch", _ARGS)
    dev = v.device
    step = launch_cols(r)
    with build.device(dev):
        st = build.stream(dev)
        for c0 in range(0, width, step):
            cw = min(step, width - c0)
            rows, tile, parts, clus, rows_f, need = plan(t, r, cw)
            scratch = torch.empty(need, dtype=torch.float32, device=dev)
            fn(build.ptr(b), build.ptr(dinv), build.ptr(einv), build.ptr(v),
               build.ptr(out), build.ptr(scratch), t, r, width, c0, cw, rows,
               tile, parts, clus, rows_f, st)
            LAUNCHES[name] += 1
            BY_SHAPE[(t, r, cw)] += 1
    return out


class _WoodburyFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, b, dinv, einv, v):
        ctx.save_for_backward(b, dinv, einv, v)
        return woodbury_apply_raw(b, dinv, einv, v)

    @staticmethod
    def backward(ctx, g):
        b, dinv, einv, v = ctx.saved_tensors
        need = ctx.needs_input_grad
        d_b = d_dinv = d_einv = d_v = None
        if need[3]:
            d_v = woodbury_apply_raw(b, dinv, einv.T.contiguous(),
                                     g.contiguous())
        if any(need[:3]):
            with torch.enable_grad():
                leaves = [x.detach().requires_grad_(n)
                          for x, n in zip((b, dinv, einv), need[:3])]
                y = woodbury_apply_ref(*leaves, v.detach())
                asked = [x for x, n in zip(leaves, need[:3]) if n]
                grads = iter(torch.autograd.grad(y, asked, g))
            d_b, d_dinv, d_einv = (next(grads) if n else None
                                   for n in need[:3])
        return d_b, d_dinv, d_einv, d_v


def woodbury_apply(b, dinv, einv, v) -> torch.Tensor:
    """Differentiable M⁻¹v (kernel forward; d_v on the kernel with E⁻ᵀ,
    payload cotangents through the plain version)."""
    return _WoodburyFn.apply(b, dinv, einv, v)
