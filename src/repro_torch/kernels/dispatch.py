"""Dispatched sparse products and walk sampling (port of
``repro/kernels/dispatch.py``).

Resolution is by device and nothing else: tensors on the CPU go to each
kernel's plain PyTorch version, tensors on a CUDA device go to the
hand-written kernel, which launches or raises.  There is no environment
variable, global or context that sends a CUDA tensor to the plain version
(the JAX registry's ``REPRO_SPMV_BACKEND`` has no counterpart here).

vals/cols are the ELL payload ([M, K]); the dense operand is [N] or [N, R].
"""
from __future__ import annotations

import torch

from .ell_spmv import ops as ell_ops
from .walk_sampler import ops as walk_ops


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


def khat_matvec(vals_rows, cols_rows, vals_cols, cols_cols, v, n_nodes: int):
    """y = Φ_rows (Φ_colsᵀ v) — the fused K̂ matvec (f32 or bf16 payloads)."""
    def payload(a):
        return a.contiguous() if a.dtype == torch.bfloat16 else _f32(a)

    return ell_ops.khat_fused(
        payload(vals_rows), cols_rows.contiguous(),
        payload(vals_cols), cols_cols.contiguous(),
        v.to(torch.float32).contiguous(), n_nodes,
    )


def walk_sample(neighbors, weights, deg, nodes, seed: int, *, n_walkers: int,
                p_halt: float, l_max: int, reweight: bool = True,
                scheme: str = "iid"):
    """(cols, loads, lens) = GRF walk deposits for ``nodes`` in ELL layout.

    The counter RNG is keyed on the absolute start-node id, so the result
    does not depend on how ``nodes`` is chunked across calls."""
    return walk_ops.walk_sample(
        neighbors.contiguous(), weights.to(torch.float32).contiguous(),
        deg.contiguous(), nodes.to(torch.int32).contiguous(), seed,
        n_walkers=n_walkers, p_halt=p_halt, l_max=l_max, reweight=reweight,
        scheme=scheme,
    )


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {**walk_ops.LAUNCHES, **ell_ops.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (walk_ops.LAUNCHES, ell_ops.LAUNCHES):
        for name in counts:
            counts[name] = 0
