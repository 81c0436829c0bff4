"""Plain PyTorch version of the fused Nyström–Woodbury preconditioner apply.

Port of ``repro/kernels/woodbury_apply/ref.py``.  The Nyström
preconditioner (solvers/nystrom.py) applies

    M⁻¹ v = D⁻¹v − D⁻¹B E⁻¹ BᵀD⁻¹v,      E = I_r + BᵀD⁻¹B,

once per CG iteration.  B [T, r], D⁻¹ [T] and E⁻¹ [r, r] are fixed across
the whole solve — only ``v`` changes — so the apply is two small products
against loop-invariant operands, a diagonal scale and a subtraction.  This
is the semantics the CUDA kernel (csrc/woodbury_apply.cu) must reproduce,
differentiable in all four operands.
"""
from __future__ import annotations

import torch


def woodbury_apply_ref(b: torch.Tensor, dinv: torch.Tensor, einv: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """M⁻¹v = D⁻¹v − D⁻¹B E⁻¹ BᵀD⁻¹v.

    b f32[T, r] (the Nyström factor), dinv f32[T] (inverse noise diagonal),
    einv f32[r, r] (inverse capacitance), v f32[T] or f32[T, R] → the shape
    of ``v``."""
    dv = dinv[:, None] if v.dim() == 2 else dinv
    w = dv * v
    s = einv @ (b.T @ w)
    return w - dv * (b @ s)
