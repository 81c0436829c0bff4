"""Wrappers of the ELL sparse-product CUDA kernels.

``ell_spmv`` (csrc/ell_spmv.cu), ``ell_spmv_t`` (csrc/ell_spmv_t.cu) and
``khat_fused`` (csrc/khat_fused.cu).  Each runs its plain version (ref.py)
on CPU tensors and launches its kernel on CUDA tensors — on PyTorch's
current stream, after checking device, dtype, shape and contiguity — or
raises.  Those are the ``*_raw`` functions.  ``ell_spmv``'s instance (the
vector or the scalar one, and its lanes and parts a row) is picked by
:func:`route`, a pure rule of R and alignment; both are CUDA.  The public
``ell_spmv``, ``ell_spmv_t`` and ``khat_fused`` wrap them in
``torch.autograd.Function``s that mirror the JAX custom VJPs
(``repro/kernels/ell_spmv/ops.py:52/77/105``):
all three products are linear in the ELL values and in the dense operand,
and each dense cotangent is itself one of the products, so the backward runs
on the same kernels (Φᵀg for Φ, Φg for Φᵀ; for K̂ two Φᵀ scatters and the
fused K̂ with the roles swapped).  The value cotangent ``_dvals``
(cot[m]·dense[cols[m,k]]) is plain PyTorch, as the JAX package computes it
outside any Pallas kernel.  A backward computes only the cotangents autograd
asks for (``needs_input_grad``), which is what XLA's dead-code elimination
leaves of the JAX VJP; the hyperparameter fit differentiates the values
only, so its K̂ backward is the two scatters.  Gradients flow through f32
payloads; bf16 payloads appear only in solves under ``torch.no_grad()``.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from .. import build
from .index import ColumnIndex, column_index
from .ref import ell_spmv_ref, ell_spmv_t_ref, khat_matvec_ref

# Kernel launches since the last reset (chip_smoke.py reads it), and the
# two ELL products' launches by (M, K, R) (R = 1 for a 1-D operand).
LAUNCHES = {"ell_spmv": 0, "ell_spmv_t": 0, "khat_fused": 0}
BY_SHAPE = {"ell_spmv": Counter(), "ell_spmv_t": Counter()}

# ell_spmv's instances (csrc/ell_spmv.cu): float4 gathers and stores, or
# float ones; a row of u covered by 1, 2, 4, ..., MAX_LANES lanes, and at
# least MIN_ROW_LANES lanes a row.
VECTOR, SCALAR = "vector", "scalar"
MAX_LANES, MIN_ROW_LANES = 32, 4

_F32 = (torch.float32,)
_PAYLOAD = (torch.float32, torch.bfloat16)
_I32 = (torch.int32,)
_VP = ctypes.c_void_p
_SPMV_ARGS = [_VP] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _VP]
_GATHER_ARGS = [_VP] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [_VP]
_KHAT_ARGS = [_VP] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [_VP]


def _check_payload(name, vals, cols, dtypes):
    build.check(name, vals, "vals", dtypes, (2,))
    build.check(name, cols, "cols", _I32, (2,))
    if vals.shape != cols.shape:
        raise ValueError(f"{name}: vals {tuple(vals.shape)} and cols "
                         f"{tuple(cols.shape)} differ")


def _width(x) -> int:
    return 1 if x.dim() == 1 else x.shape[1]


def aligned(*tensors) -> bool:
    """Every tensor's base is 16-byte aligned (a slice may not be)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def route(r: int, aligned: bool) -> tuple[str, int, int]:
    """``ell_spmv``'s instance for R columns of u, its lanes covering a row
    of u and the parts a row's slots are split into.

    ``VECTOR`` (16-byte gathers and stores) when R % 4 == 0 and u and y are
    16-byte aligned (``aligned``), else ``SCALAR``.  The lanes are the least
    power of two covering a row of u in the instance's units (R/4 float4s
    or R floats), at most ``MAX_LANES`` (wider rows are walked in column
    chunks); the parts make at least ``MIN_ROW_LANES`` lanes a row, a warp
    taking 32/(lanes·parts) rows."""
    if r < 1:
        raise ValueError(f"ell_spmv: R must be at least 1, got {r}")
    vector = r % 4 == 0 and aligned
    units = r // 4 if vector else r
    lanes = min(MAX_LANES, 1 << (units - 1).bit_length())
    return (VECTOR if vector else SCALAR, lanes, max(1, MIN_ROW_LANES // lanes))


def ell_spmv_raw(vals: torch.Tensor, cols: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """y = Φ u: vals f32[M, K], cols i32[M, K], u f32[N(, R)] → f32[M(, R)].

    An empty y (M = 0 or R = 0) launches nothing."""
    name = "ell_spmv"
    if not build.on_cuda(name, vals, cols, u):
        return ell_spmv_ref(vals, cols, u)
    _check_payload(name, vals, cols, _F32)
    build.check(name, u, "u", _F32, (1, 2))
    m, k = vals.shape
    r = _width(u)
    y = torch.empty((m,) + tuple(u.shape[1:]), dtype=torch.float32,
                    device=u.device)
    if y.numel() == 0:
        return y
    instance, lanes, parts = route(r, aligned(u, y))
    vec_payload = k % 4 == 0 and aligned(vals, cols)
    fn = build.bind(name, "ell_spmv_launch", _GATHER_ARGS)
    with build.device(u.device):
        fn(build.ptr(vals), build.ptr(cols), build.ptr(u), build.ptr(y), m, k,
           r, int(instance == VECTOR), lanes, parts, int(vec_payload),
           build.stream(u.device))
    LAUNCHES[name] += 1
    BY_SHAPE[name][(m, k, r)] += 1
    return y


def ell_spmv_t_raw(vals: torch.Tensor, cols: torch.Tensor, v: torch.Tensor,
                   n_nodes: int) -> torch.Tensor:
    """u = Φᵀ v: vals f32[M, K], cols i32[M, K], v f32[M(, R)] → f32[N(, R)]."""
    name = "ell_spmv_t"
    if not build.on_cuda(name, vals, cols, v):
        return ell_spmv_t_ref(vals, cols, v, n_nodes)
    _check_payload(name, vals, cols, _F32)
    build.check(name, v, "v", _F32, (1, 2))
    m, k = vals.shape
    if v.shape[0] != m:
        raise ValueError(f"{name}: v has {v.shape[0]} rows, payload {m}")
    out = torch.zeros((n_nodes,) + tuple(v.shape[1:]), dtype=torch.float32,
                      device=v.device)
    fn = build.bind(name, "ell_spmv_t_launch", _SPMV_ARGS)
    with build.device(v.device):
        fn(build.ptr(vals), build.ptr(cols), build.ptr(v), build.ptr(out), m,
           k, _width(v), build.stream(v.device))
    LAUNCHES[name] += 1
    BY_SHAPE[name][(m, k, _width(v))] += 1
    return out


def khat_fused_raw(vals_rows: torch.Tensor, cols_rows: torch.Tensor,
                   vals_cols: torch.Tensor, cols_cols: torch.Tensor,
                   v: torch.Tensor, n_nodes: int,
                   index: ColumnIndex | None = None) -> torch.Tensor:
    """y = Φ_rows (Φ_colsᵀ v); payloads f32 or bf16, each side its own.

    vals_rows [M_r, K_r], vals_cols [M_c, K_c], v f32[M_c(, R)] →
    f32[M_r(, R)].  ``index`` is the column index of the column payload
    (``column_index(cols_cols, ·, n_nodes)``, index.py), which a caller
    keeps for every product with the same columns; without one it is built
    here, which gives the same result, only slower.  A bf16 payload beside
    an f32 one is upcast (exactly) and the f32 instance runs."""
    name = "khat_fused"
    if not build.on_cuda(name, vals_rows, cols_rows, vals_cols, cols_cols, v):
        return khat_matvec_ref(vals_rows, cols_rows, vals_cols, cols_cols, v,
                               n_nodes)
    _check_payload(name, vals_rows, cols_rows, _PAYLOAD)
    _check_payload(name, vals_cols, cols_cols, _PAYLOAD)
    build.check(name, v, "v", _F32, (1, 2))
    m_r, k_r = vals_rows.shape
    m_c, k_c = vals_cols.shape
    if v.shape[0] != m_c:
        raise ValueError(f"{name}: v has {v.shape[0]} rows, column payload {m_c}")
    if vals_rows.dtype != vals_cols.dtype:
        vals_rows, vals_cols = _f32c(vals_rows), _f32c(vals_cols)
    dev = v.device
    if index is None:
        index = column_index(cols_cols, vals_cols, n_nodes)
    elif (index.shape != (m_c, k_c) or index.n_nodes != n_nodes
          or index.node_map.device != dev):
        raise ValueError(f"{name}: index of a {index.shape} payload over "
                         f"{index.n_nodes} nodes on {index.node_map.device}, "
                         f"not {(m_c, k_c)} over {n_nodes} on {dev}")
    r = _width(v)
    u = torch.empty((index.n_uniq * r,), dtype=torch.float32, device=dev)
    y = torch.empty((m_r,) + tuple(v.shape[1:]), dtype=torch.float32,
                    device=dev)
    if r == 0:
        return y
    fn = build.bind(name, "khat_fused_launch", _KHAT_ARGS)
    with build.device(dev):
        fn(build.ptr(vals_rows), build.ptr(cols_rows), build.ptr(vals_cols),
           build.ptr(index.order), build.ptr(index.seg),
           build.ptr(index.node_map), build.ptr(v), build.ptr(u), build.ptr(y),
           m_r, k_r, k_c, index.n_uniq, r,
           int(vals_rows.dtype == torch.bfloat16), build.stream(dev))
    LAUNCHES[name] += 1
    return y


# --- autograd ---------------------------------------------------------------


def _dvals(cot_rows, cols, dense):
    """∂⟨cot, Φ·⟩/∂vals[m,k] = cot[m]·dense[cols[m,k]] (Σ_r for several
    right-hand sides) — plain PyTorch, like the JAX package's ``_dvals``."""
    gathered = dense[cols.long()]  # [M, K] or [M, K, R]
    if dense.dim() == 1:
        return cot_rows[:, None] * gathered
    return torch.einsum("mr,mkr->mk", cot_rows, gathered)


def _f32c(x):
    return x.to(torch.float32).contiguous()


class _SpmvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, cols, u):
        ctx.save_for_backward(vals, cols, u)
        return ell_spmv_raw(vals, cols, u)

    @staticmethod
    def backward(ctx, g):
        vals, cols, u = ctx.saved_tensors
        g = _f32c(g)
        d_vals = d_u = None
        if ctx.needs_input_grad[0]:
            d_vals = _dvals(g, cols, u).to(vals.dtype)
        if ctx.needs_input_grad[2]:
            d_u = ell_spmv_t_raw(vals, cols, g, u.shape[0])
        return d_vals, None, d_u


class _SpmvTFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, cols, v, n_nodes):
        ctx.save_for_backward(vals, cols, v)
        return ell_spmv_t_raw(vals, cols, v, n_nodes)

    @staticmethod
    def backward(ctx, g):
        vals, cols, v = ctx.saved_tensors
        g = _f32c(g)
        d_vals = d_v = None
        if ctx.needs_input_grad[0]:
            d_vals = _dvals(v, cols, g).to(vals.dtype)
        if ctx.needs_input_grad[2]:
            d_v = ell_spmv_raw(vals, cols, g)
        return d_vals, None, d_v, None


class _KhatFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals_g, cols_g, vals_s, cols_s, v, n_nodes, index_s):
        ctx.save_for_backward(vals_g, cols_g, vals_s, cols_s, v)
        ctx.n_nodes = n_nodes
        return khat_fused_raw(vals_g, cols_g, vals_s, cols_s, v, n_nodes,
                              index_s)

    @staticmethod
    def backward(ctx, g):
        # y = Φg u, u = Φsᵀ v.  Cotangents (recomputed with the kernels):
        #   d_v      = Φs Φgᵀ g             (fused, roles swapped, through
        #                                    an index of Φg built here)
        #   d_vals_g = g ⊙ u[cols_g],  u = Φsᵀ v
        #   d_vals_s = v ⊙ w[cols_s],  w = Φgᵀ g
        vals_g, cols_g, vals_s, cols_s, v = ctx.saved_tensors
        n = ctx.n_nodes
        g = _f32c(g)
        d_g = d_s = d_v = None
        if ctx.needs_input_grad[0]:
            u = ell_spmv_t_raw(_f32c(vals_s), cols_s, v, n)
            d_g = _dvals(g, cols_g, u).to(vals_g.dtype)
        if ctx.needs_input_grad[2]:
            w = ell_spmv_t_raw(_f32c(vals_g), cols_g, g, n)
            d_s = _dvals(v, cols_s, w).to(vals_s.dtype)
        if ctx.needs_input_grad[4]:
            d_v = khat_fused_raw(vals_s, cols_s, vals_g, cols_g, g, n)
        return d_g, None, d_s, None, d_v, None, None


def ell_spmv(vals, cols, u) -> torch.Tensor:
    """Differentiable y = Φ u (see :func:`ell_spmv_raw`)."""
    return _SpmvFn.apply(vals, cols, u)


def ell_spmv_t(vals, cols, v, n_nodes: int) -> torch.Tensor:
    """Differentiable u = Φᵀ v (see :func:`ell_spmv_t_raw`)."""
    return _SpmvTFn.apply(vals, cols, v, n_nodes)


def khat_fused(vals_rows, cols_rows, vals_cols, cols_cols, v, n_nodes: int,
               index: ColumnIndex | None = None) -> torch.Tensor:
    """Differentiable y = Φ_rows (Φ_colsᵀ v) (see :func:`khat_fused_raw`;
    ``index`` is the column payload's)."""
    return _KhatFn.apply(vals_rows, cols_rows, vals_cols, cols_cols, v,
                         n_nodes, index)
