"""Plain PyTorch version of the fused RMSNorm kernel (port of
``repro/kernels/rmsnorm/ref.py``)."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = x / rms(x) * (1 + scale), rms over the last dim, math in f32."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale.to(torch.float32))).to(dtype)
