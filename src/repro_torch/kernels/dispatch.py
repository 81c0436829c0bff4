"""Dispatched sparse products, walk sampling and the Woodbury apply (port of
``repro/kernels/dispatch.py``).

Resolution is by device and nothing else: tensors on the CPU go to each
kernel's plain PyTorch version, tensors on a CUDA device go to the
hand-written kernel, which launches or raises.  There is no environment
variable, global or context that sends a CUDA tensor to the plain version
(the JAX registry's ``REPRO_SPMV_BACKEND`` has no counterpart here).

vals/cols are the ELL payload ([M, K]); the dense operand is [N] or [N, R].
Every product is differentiable in its values and its dense operand
(autograd Functions in the kernels' ``ops.py``); the casts here stay
differentiable around them.

:func:`walk_sample` counts its rows, walkers and calls into the obs
registry (when enabled) with the labels ``{"scheme", "backend"}`` of the
JAX package.  With no backend registry here, ``backend`` holds the device
type of the call's tensors — ``"cuda"`` (the kernel) or ``"cpu"`` (the
plain version) — everywhere the port writes that label.
"""
from __future__ import annotations

import torch

from ..obs import taps as _obs_taps
from .ell_spmv import ops as ell_ops
from .flash_attention import ops as flash_ops
from .gram_block import ops as gram_ops
from .rmsnorm import ops as rmsnorm_ops
from .walk_sampler import ops as walk_ops
from .woodbury_apply import ops as wood_ops

# Every kernel's launch count; the LM scaffold's two kernels are called
# through their own modules (models/layers.py, models/attention.py).
_COUNTERS = (walk_ops.LAUNCHES, ell_ops.LAUNCHES, gram_ops.LAUNCHES,
             wood_ops.LAUNCHES, flash_ops.LAUNCHES, rmsnorm_ops.LAUNCHES)


def _f32(vals: torch.Tensor) -> torch.Tensor:
    # The gather and scatter kernels read float32 payloads; a bf16 payload
    # upcasts exactly (only the fused K̂ kernel streams bf16 itself).
    return vals.to(torch.float32).contiguous()


def phi_matvec(vals, cols, u):
    """y = Φ u (gather-reduce)."""
    return ell_ops.ell_spmv(_f32(vals), cols.contiguous(),
                            u.to(torch.float32).contiguous())


def phi_t_matvec(vals, cols, v, n_nodes: int):
    """u = Φᵀ v (scatter-add)."""
    return ell_ops.ell_spmv_t(_f32(vals), cols.contiguous(),
                              v.to(torch.float32).contiguous(), n_nodes)


def khat_matvec(vals_rows, cols_rows, vals_cols, cols_cols, v, n_nodes: int,
                index=None):
    """y = Φ_rows (Φ_colsᵀ v) — the fused K̂ matvec (f32 or bf16 payloads).

    ``index``: the column payload's column index
    (``WalkTrace.column_index``), built by the kernel's wrapper where not
    given."""
    def payload(a):
        return a.contiguous() if a.dtype == torch.bfloat16 else _f32(a)

    return ell_ops.khat_fused(
        payload(vals_rows), cols_rows.contiguous(),
        payload(vals_cols), cols_cols.contiguous(),
        v.to(torch.float32).contiguous(), n_nodes, index,
    )


def gram_block(vals_rows, cols_rows, vals_cols, cols_cols):
    """G = Φ_rows Φ_colsᵀ [M_r, M_c] between two ELL payloads — the N-free
    sparse×sparse cross-Gram (duplicate deposit columns exact)."""
    return gram_ops.gram_block(_f32(vals_rows), cols_rows.contiguous(),
                               _f32(vals_cols), cols_cols.contiguous())


def woodbury_apply(b, dinv, einv, v):
    """M⁻¹v = D⁻¹v − D⁻¹B E⁻¹ BᵀD⁻¹v — the Nyström preconditioner apply
    (B [T, r], D⁻¹ [T], E⁻¹ [r, r], v [T] or [T, R])."""
    return wood_ops.woodbury_apply(_f32(b), _f32(dinv), _f32(einv),
                                   v.to(torch.float32).contiguous())


def walk_sample(neighbors, weights, deg, nodes, seed: int, *, n_walkers: int,
                p_halt: float, l_max: int, reweight: bool = True,
                scheme: str = "iid"):
    """(cols, loads, lens) = GRF walk deposits for ``nodes`` in ELL layout.

    The counter RNG is keyed on the absolute start-node id, so the result
    does not depend on how ``nodes`` is chunked across calls."""
    labels = {"scheme": scheme, "backend": nodes.device.type}
    rows = int(nodes.shape[0])
    _obs_taps.count("walks.rows_sampled", n=rows, labels=labels)
    _obs_taps.count("walks.walkers_launched", n=rows * int(n_walkers),
                    labels=labels)
    _obs_taps.count("walks.sample_calls", labels=labels)
    return walk_ops.walk_sample(
        neighbors.contiguous(), weights.to(torch.float32).contiguous(),
        deg.contiguous(), nodes.to(torch.int32).contiguous(), seed,
        n_walkers=n_walkers, p_halt=p_halt, l_max=l_max, reweight=reweight,
        scheme=scheme,
    )


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {k: v for counts in _COUNTERS for k, v in counts.items()}


def launch_shapes() -> dict[str, dict[tuple, int]]:
    """Launches by shape since the last reset: ``walk_sampler`` by (M, K),
    ``woodbury_apply`` by (T, r, columns), ``ell_spmv`` and ``ell_spmv_t``
    by (M, K, R)."""
    return {"walk_sampler": dict(walk_ops.BY_SHAPE),
            "woodbury_apply": dict(wood_ops.BY_SHAPE),
            **{name: dict(by) for name, by in ell_ops.BY_SHAPE.items()}}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0
    for by in (walk_ops.BY_SHAPE, wood_ops.BY_SHAPE, *ell_ops.BY_SHAPE.values()):
        by.clear()
