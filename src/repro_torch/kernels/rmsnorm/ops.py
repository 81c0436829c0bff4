"""Wrapper of the fused RMSNorm CUDA kernel (csrc/rmsnorm.cu).

:func:`apply` runs the plain version (ref.py) on CPU tensors and launches the
kernel on CUDA tensors — on PyTorch's current stream, after checking device,
dtype and shape — or raises.  It takes ``x`` of any rank ``[..., D]`` (the
kernel sees ``[M, D]``), float32 or bfloat16, and returns ``x``'s dtype; the
scale is read as float32.  The JAX wrapper's ``use_pallas``/``interpret``
switches have no counterpart: the device decides.
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


def apply(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = x·rsqrt(mean(x²) + eps)·(1 + scale) over the last dim."""
    name = "rmsnorm"
    if not build.on_cuda(name, x, scale):
        return rmsnorm_ref(x, scale, eps)
    d = x.shape[-1]
    scale = scale.to(torch.float32).contiguous()
    if tuple(scale.shape) != (d,):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} is not [{d}]")
    xm = x.reshape(-1, d).contiguous()
    build.check(name, xm, "x", _X, (2,))
    out = torch.empty_like(xm)
    if xm.shape[0] == 0 or d == 0:
        return out.reshape(x.shape)
    dev = x.device
    fn = build.bind(name, "rmsnorm_launch", _ARGS)
    with torch.cuda.device(dev):
        fn(build.ptr(xm), build.ptr(scale), build.ptr(out), xm.shape[0], d,
           float(eps), int(xm.dtype == torch.bfloat16), build.stream(dev))
    LAUNCHES[name] += 1
    return out.reshape(x.shape)
