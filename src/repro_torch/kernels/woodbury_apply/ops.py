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
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import woodbury_apply_ref

# Kernel launches since the last reset (chip_smoke.py reads it).
LAUNCHES = {"woodbury_apply": 0}

MAX_COLS = 64          # the kernel's widest v; wider runs as 64-column launches

_F32 = (torch.float32,)
_VP = ctypes.c_void_p
_ARGS = [_VP] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _VP]


def _scratch_floats(t: int, r: int, cols: int) -> int:
    """Floats of scratch one launch needs, as the kernel's own tiling counts
    them (−1 when it does not take this r or width)."""
    fn = build.load("woodbury_apply").woodbury_apply_scratch_floats
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return fn(t, r, cols)


def woodbury_apply_raw(b: torch.Tensor, dinv: torch.Tensor, einv: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """M⁻¹v: b f32[T, r], dinv f32[T], einv f32[r, r], v f32[T(, R)] →
    f32 of ``v``'s shape."""
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
    cols = 1 if v.dim() == 1 else v.shape[1]
    if cols > MAX_COLS:
        return torch.cat([
            woodbury_apply_raw(b, dinv, einv, v[:, c0:c0 + MAX_COLS].contiguous())
            for c0 in range(0, cols, MAX_COLS)], dim=1)
    out = torch.empty_like(v)
    if t == 0 or cols == 0:
        return out
    need = _scratch_floats(t, r, cols)
    if need < 0:
        raise ValueError(f"{name}: the kernel does not take rank {r}")
    dev = v.device
    scratch = torch.empty(need, dtype=torch.float32, device=dev)
    fn = build.bind(name, "woodbury_apply_launch", _ARGS)
    with build.device(dev):
        fn(build.ptr(b), build.ptr(dinv), build.ptr(einv), build.ptr(v),
           build.ptr(out), build.ptr(scratch), t, r, cols, build.stream(dev))
    LAUNCHES[name] += 1
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
