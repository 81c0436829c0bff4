"""Wrappers of the ELL sparse-product CUDA kernels.

``ell_spmv`` (csrc/ell_spmv.cu), ``ell_spmv_t`` (csrc/ell_spmv_t.cu) and
``khat_fused`` (csrc/khat_fused.cu).  Each runs its plain version (ref.py)
on CPU tensors and launches its kernel on CUDA tensors — on PyTorch's
current stream, after checking device, dtype, shape and contiguity — or
raises.  Forward only: the autograd Functions that mirror the JAX custom
VJPs (``repro/kernels/ell_spmv/ops.py:52/77/105``) come with the training
path.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import ell_spmv_ref, ell_spmv_t_ref, khat_matvec_ref

# Kernel launches since the last reset (chip_smoke.py reads it).
LAUNCHES = {"ell_spmv": 0, "ell_spmv_t": 0, "khat_fused": 0}

_F32 = (torch.float32,)
_PAYLOAD = (torch.float32, torch.bfloat16)
_I32 = (torch.int32,)
_VP = ctypes.c_void_p
_SPMV_ARGS = [_VP] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _VP]
_KHAT_ARGS = [_VP] * 7 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _VP,
]


def _check_payload(name, vals, cols, dtypes):
    build.check(name, vals, "vals", dtypes, (2,))
    build.check(name, cols, "cols", _I32, (2,))
    if vals.shape != cols.shape:
        raise ValueError(f"{name}: vals {tuple(vals.shape)} and cols "
                         f"{tuple(cols.shape)} differ")


def _width(x) -> int:
    return 1 if x.dim() == 1 else x.shape[1]


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor,
             u: torch.Tensor) -> torch.Tensor:
    """y = Φ u: vals f32[M, K], cols i32[M, K], u f32[N(, R)] → f32[M(, R)]."""
    name = "ell_spmv"
    if not build.on_cuda(name, vals, cols, u):
        return ell_spmv_ref(vals, cols, u)
    _check_payload(name, vals, cols, _F32)
    build.check(name, u, "u", _F32, (1, 2))
    m, k = vals.shape
    y = torch.empty((m,) + tuple(u.shape[1:]), dtype=torch.float32,
                    device=u.device)
    fn = build.bind(name, "ell_spmv_launch", _SPMV_ARGS)
    with torch.cuda.device(u.device):
        fn(build.ptr(vals), build.ptr(cols), build.ptr(u), build.ptr(y), m, k,
           _width(u), build.stream(u.device))
    LAUNCHES[name] += 1
    return y


def ell_spmv_t(vals: torch.Tensor, cols: torch.Tensor, v: torch.Tensor,
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
    with torch.cuda.device(v.device):
        fn(build.ptr(vals), build.ptr(cols), build.ptr(v), build.ptr(out), m,
           k, _width(v), build.stream(v.device))
    LAUNCHES[name] += 1
    return out


def khat_fused(vals_rows: torch.Tensor, cols_rows: torch.Tensor,
               vals_cols: torch.Tensor, cols_cols: torch.Tensor,
               v: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """y = Φ_rows (Φ_colsᵀ v) in one launch; payloads f32 or bf16.

    vals_rows [M_r, K_r], vals_cols [M_c, K_c], v f32[M_c(, R)] →
    f32[M_r(, R)].  The N(·R)-float intermediate is a scratch buffer the
    kernel zeroes itself."""
    name = "khat_fused"
    if not build.on_cuda(name, vals_rows, cols_rows, vals_cols, cols_cols, v):
        return khat_matvec_ref(vals_rows, cols_rows, vals_cols, cols_cols, v,
                               n_nodes)
    _check_payload(name, vals_rows, cols_rows, _PAYLOAD)
    _check_payload(name, vals_cols, cols_cols, _PAYLOAD)
    if vals_rows.dtype != vals_cols.dtype:
        raise TypeError(f"{name}: row payload {vals_rows.dtype} and column "
                        f"payload {vals_cols.dtype} differ")
    build.check(name, v, "v", _F32, (1, 2))
    m_r, k_r = vals_rows.shape
    m_c, k_c = vals_cols.shape
    if v.shape[0] != m_c:
        raise ValueError(f"{name}: v has {v.shape[0]} rows, column payload {m_c}")
    dev = v.device
    r = _width(v)
    u = torch.empty((n_nodes * r,), dtype=torch.float32, device=dev)
    y = torch.empty((m_r,) + tuple(v.shape[1:]), dtype=torch.float32,
                    device=dev)
    fn = build.bind(name, "khat_fused_launch", _KHAT_ARGS)
    with torch.cuda.device(dev):
        fn(build.ptr(vals_rows), build.ptr(cols_rows), build.ptr(vals_cols),
           build.ptr(cols_cols), build.ptr(v), build.ptr(u), build.ptr(y),
           m_r, k_r, m_c, k_c, n_nodes, r,
           int(vals_rows.dtype == torch.bfloat16), build.stream(dev))
    LAUNCHES[name] += 1
    return y
