"""Wrapper of the fused RMSNorm CUDA kernel (csrc/rmsnorm.cu).

:func:`apply` runs the plain version (ref.py) on CPU tensors and launches the
kernel on CUDA tensors — on PyTorch's current stream, after checking device,
dtype and shape — or raises.  It takes ``x`` of any rank ``[..., D]`` (the
kernel sees ``[M, D]``), float32 or bfloat16, and returns ``x``'s dtype; the
scale is read as float32.  The JAX wrapper's ``use_pallas``/``interpret``
switches have no counterpart: the device decides.

Gradients: when grad mode is on and x or the scale requires grad, the call
goes through an autograd Function whose forward is :func:`launch` and whose
backward recomputes ``rmsnorm_ref`` under ``torch.enable_grad()`` and takes
``torch.autograd.grad`` of it (the JAX package has no backward kernel to
port: its ``rms_norm`` is plain ``jnp``).  It saves only x and the scale;
with nothing requiring grad :func:`launch` is called directly.

Sharded inputs: a DTensor ``x`` (the LM under ``launch/sharding.py``'s
placements) is normalised shard by shard through ``local_map``: x is first
redistributed so that its last dim is whole on every rank (a placement
that shards it, or a partial sum, becomes a replicate), the scale (a
DTensor too) is replicated, and each rank runs :func:`apply` on its local
rows — the kernel on the card, the plain version on the CPU.  The scale's
gradient is a partial sum over the mesh dims that split x.

A decode step calls this 49 times and is bound by host time, so the path on
the card does no more than it must: no cast or copy of a scale that is
already float32 and contiguous, no reshape of an x that is already 2-D and
contiguous, no device switch when x's device is current, the stream read as
a raw pointer, the C entry point bound once.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import rmsnorm_ref

# Kernel launches since the last reset (chip_smoke.py reads it).
LAUNCHES = {"rmsnorm": 0}

_X = (torch.float32, torch.bfloat16)
_VP = ctypes.c_void_p
_ARGS = [_VP, _VP, _VP, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
         ctypes.c_int, _VP]
_FN = []   # the bound entry point, once built


def apply(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = x·rsqrt(mean(x²) + eps)·(1 + scale) over the last dim."""
    if build.is_dtensor(x):
        return _sharded(x, scale, eps)
    if not build.on_cuda("rmsnorm", x, scale):
        return rmsnorm_ref(x, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RmsNormFn.apply(x, scale, eps)
    return launch(x, scale, eps)


def _sharded(x, scale, eps: float):
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    whole = tuple(Replicate() if p.is_partial() or (p.is_shard() and p.dim == x.dim() - 1)
                  else p for p in x.placements)
    rep = (Replicate(),) * mesh.ndim
    x = x.redistribute(mesh, whole)
    scale = scale.redistribute(mesh, rep)
    return local_map(apply, out_placements=(whole,), device_mesh=mesh,
                     in_grad_placements=(whole, build.grad_placements(rep, whole), None))(
        x, scale, eps)


class _RmsNormFn(torch.autograd.Function):
    """The kernel's forward; the backward through the plain version."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return launch(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            out = rmsnorm_ref(*ins, ctx.eps)
            grads = iter(torch.autograd.grad(
                out, [t for t in ins if t.requires_grad], g))
        return (*(next(grads) if n else None for n in need), None)


def launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the kernel on CUDA tensors (checks, then one launch)."""
    name = "rmsnorm"
    d = x.shape[-1]
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        scale = scale.to(torch.float32).contiguous()
    if scale.shape != (d,):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} is not [{d}]")
    xm = x if x.dim() == 2 and x.is_contiguous() else x.reshape(-1, d).contiguous()
    build.check(name, xm, "x", _X, (2,))
    out = torch.empty_like(xm)
    if xm.shape[0] == 0 or d == 0:
        return out.reshape(x.shape)
    if not _FN:
        _FN.append(build.bind(name, "rmsnorm_launch", _ARGS))
    dev = x.device
    with build.device(dev):
        _FN[0](xm.data_ptr(), scale.data_ptr(), out.data_ptr(), xm.shape[0], d,
               eps, xm.dtype == torch.bfloat16, build.stream(dev))
    LAUNCHES[name] += 1
    return out if out.shape == x.shape else out.reshape(x.shape)
