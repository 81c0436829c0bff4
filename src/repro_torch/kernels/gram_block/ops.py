"""Wrapper of the cross-Gram CUDA kernel (csrc/gram_block.cu) and its
autograd Function.

``gram_block_raw`` runs the plain version (ref.py) on CPU tensors and
launches the kernel on CUDA tensors — on PyTorch's current stream, after
checking device, dtype, shape and contiguity — or raises.
``aggregate_rows_raw`` does the same for the kernel's first step alone on
one payload (``gram_aggregate``), which the coalesced K̂ payload is built
from (core/features.py ``coalesce``).
:func:`gram_block` wraps it in a ``torch.autograd.Function`` that mirrors
the JAX custom VJP (``repro/kernels/gram_block/ops.py:42``): G is bilinear
in the two value payloads and each cotangent is a weighted sparse lookup,

    d_vals_rows[i,k] = Σ_j g[i,j] · Φ_cols[j, cols_rows[i,k]]
    d_vals_cols[j,l] = Σ_i g[i,j] · Φ_rows[i, cols_cols[j,l]],

computed by the plain ``gram_lookup_ref`` on both sides, as the JAX package
does (it has no Pallas kernel for the backward either).
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import aggregate_rows_ref, gram_block_ref, gram_lookup_ref

# Kernel launches since the last reset (chip_smoke.py reads it).
LAUNCHES = {"gram_block": 0, "gram_aggregate": 0}

_F32 = (torch.float32,)
_I32 = (torch.int32,)
_VP = ctypes.c_void_p
_ARGS = [_VP] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_int, _VP]
_AGG_ARGS = [_VP] * 5 + [ctypes.c_longlong, ctypes.c_int, _VP]


def _check(name, vals, cols, side):
    build.check(name, vals, f"vals_{side}", _F32, (2,))
    build.check(name, cols, f"cols_{side}", _I32, (2,))
    if vals.shape != cols.shape:
        raise ValueError(f"{name}: vals_{side} {tuple(vals.shape)} and "
                         f"cols_{side} {tuple(cols.shape)} differ")


def gram_block_raw(vals_rows: torch.Tensor, cols_rows: torch.Tensor,
                   vals_cols: torch.Tensor, cols_cols: torch.Tensor) -> torch.Tensor:
    """G = Φ_rows Φ_colsᵀ: f32/i32 [M_r, K_r] × [M_c, K_c] → f32[M_r, M_c]."""
    name = "gram_block"
    if not build.on_cuda(name, vals_rows, cols_rows, vals_cols, cols_cols):
        return gram_block_ref(vals_rows, cols_rows, vals_cols, cols_cols)
    _check(name, vals_rows, cols_rows, "rows")
    _check(name, vals_cols, cols_cols, "cols")
    m_r, k_r = vals_rows.shape
    m_c, k_c = vals_cols.shape
    dev = vals_rows.device
    out = torch.empty((m_r, m_c), dtype=torch.float32, device=dev)
    if m_r == 0 or m_c == 0:
        return out
    # The kernel's aggregated rows: columns and sums of both payloads, and
    # each row's count of distinct entries.
    scratch = torch.empty((2 * (m_r * k_r + m_c * k_c) + m_r + m_c,),
                          dtype=torch.int32, device=dev)
    fn = build.bind(name, "gram_block_launch", _ARGS)
    with build.device(dev):
        fn(build.ptr(vals_rows), build.ptr(cols_rows), build.ptr(vals_cols),
           build.ptr(cols_cols), build.ptr(out), build.ptr(scratch), m_r, k_r,
           m_c, k_c, build.stream(dev))
    LAUNCHES[name] += 1
    return out


def aggregate_rows_raw(vals: torch.Tensor, cols: torch.Tensor):
    """Each row's distinct (column, Σ value) entries over its non-zero
    slots, in order of first occurrence (``aggregate_rows_ref``, bit for
    bit): f32/i32 [M, K] → (cols i32[M, K], sums f32[M, K], counts
    i32[M]); entries past a row's count are column −1 and value 0 (the
    kernel writes a row's padding only up to the next multiple of 32, so the
    outputs start filled)."""
    name = "gram_aggregate"
    if not build.on_cuda(name, vals, cols):
        return aggregate_rows_ref(vals, cols)
    build.check(name, vals, "vals", _F32, (2,))
    build.check(name, cols, "cols", _I32, (2,))
    if vals.shape != cols.shape:
        raise ValueError(f"{name}: vals {tuple(vals.shape)} and cols "
                         f"{tuple(cols.shape)} differ")
    m, k = vals.shape
    dev = vals.device
    out_c = torch.full((m, k), -1, dtype=torch.int32, device=dev)
    out_v = torch.zeros((m, k), dtype=torch.float32, device=dev)
    counts = torch.zeros((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return out_c, out_v, counts
    fn = build.bind("gram_block", "gram_aggregate_launch", _AGG_ARGS)
    with build.device(dev):
        fn(build.ptr(vals), build.ptr(cols), build.ptr(out_c), build.ptr(out_v),
           build.ptr(counts), m, k, build.stream(dev))
    LAUNCHES[name] += 1
    return out_c, out_v, counts


class _GramFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals_rows, cols_rows, vals_cols, cols_cols):
        ctx.save_for_backward(vals_rows, cols_rows, vals_cols, cols_cols)
        return gram_block_raw(vals_rows, cols_rows, vals_cols, cols_cols)

    @staticmethod
    def backward(ctx, g):
        vals_rows, cols_rows, vals_cols, cols_cols = ctx.saved_tensors
        d_rows = d_cols = None
        if ctx.needs_input_grad[0]:
            d_rows = gram_lookup_ref(g, vals_cols, cols_cols, cols_rows)
        if ctx.needs_input_grad[2]:
            d_cols = gram_lookup_ref(g.T, vals_rows, cols_rows, cols_cols)
        return d_rows, None, d_cols, None


def gram_block(vals_rows, cols_rows, vals_cols, cols_cols) -> torch.Tensor:
    """Differentiable G = Φ_rows Φ_colsᵀ (kernel forward, plain lookups back)."""
    return _GramFn.apply(vals_rows, cols_rows, vals_cols, cols_cols)
