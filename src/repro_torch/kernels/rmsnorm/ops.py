"""Wrapper of the fused RMSNorm CUDA kernel (csrc/rmsnorm.cu).

:func:`apply` runs the plain version (ref.py) on CPU tensors and launches the
kernel on CUDA tensors — on PyTorch's current stream, after checking device,
dtype and shape — or raises.  It takes ``x`` of any rank ``[..., D]`` (the
kernel sees ``[M, D]``), float32 or bfloat16, and returns ``x``'s dtype; the
scale is read as float32.  The JAX wrapper's ``use_pallas``/``interpret``
switches have no counterpart: the device decides.

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
    name = "rmsnorm"
    if not build.on_cuda(name, x, scale):
        return rmsnorm_ref(x, scale, eps)
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
