"""The column index of an ELL payload, which the fused K̂ kernel reads.

y = Φ_rows (Φ_colsᵀ v) needs u = Φ_colsᵀ v only on the columns that a
non-zero slot of Φ_cols touches: U of them, against N nodes (10 822 of 10⁶
at the posterior's training block).  :func:`column_index` lists them once,
with the non-zero slots grouped by column, so that the kernel (csrc/
khat_fused.cu) sums u = Φ_colsᵀv into a compact [U(, R)] buffer by
segments, with no N-long zeroing and no atomics, and gathers Φ_rows u
through a node → compact-id map.

The index depends on the payload's columns and on which of its slots are
non-zero, not on the values: built from a walk trace's ``cols`` and
``loads`` (a slot whose load is 0 has value 0 for every modulation), it
serves every product with that trace, whatever ``f`` is — every CG
iteration, fit step and later call.  ``WalkTrace.column_index`` keeps it on
the trace.  It is built by PyTorch ops on the payload's device, with one
host read (the count of non-zero slots, then U).
"""
from __future__ import annotations

import dataclasses

import torch

_I32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class ColumnIndex:
    """The non-zero slots of an ELL payload [M, K] grouped by column.

    Attributes:
      uniq:     int32[U] the distinct columns of the non-zero slots, ascending.
      order:    int32[nnz] flat slot indices m·K + k of the non-zero slots,
                by column, and within a column in slot order.
      seg:      int32[U + 1] the slots of ``uniq[u]`` are
                ``order[seg[u]:seg[u + 1]]``.
      node_map: int32[N] the compact id u of each node, −1 where no
                non-zero slot lands.
      shape:    (M, K) of the payload it was built from.
    """

    uniq: torch.Tensor
    order: torch.Tensor
    seg: torch.Tensor
    node_map: torch.Tensor
    shape: tuple[int, int]

    @property
    def n_uniq(self) -> int:
        return self.uniq.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.node_map.shape[0]


def column_index(cols: torch.Tensor, weights: torch.Tensor,
                 n_nodes: int, nnz: int | None = None) -> ColumnIndex:
    """Index the slots of ``cols`` [M, K] whose ``weights`` are non-zero.

    ``weights`` is the payload's values, or any tensor of its shape that is 0
    wherever the values are (a trace's loads).  Columns must lie in
    [0, n_nodes).  ``nnz``, where the caller knows it, is the number of
    non-zero ``weights``: the slots are then found without reading their
    count back to the host."""
    if cols.shape != weights.shape or cols.dim() != 2:
        raise ValueError(f"column_index: cols {tuple(cols.shape)} and weights "
                         f"{tuple(weights.shape)} must be one 2-D shape")
    if cols.numel() > _I32_MAX or n_nodes > _I32_MAX:
        raise ValueError("column_index: the payload or the graph exceeds "
                         "int32 slot and node ids")
    dev = cols.device
    live = weights.reshape(-1) != 0
    keep = (torch.nonzero(live) if nnz is None
            else torch.nonzero_static(live, size=nnz)).reshape(-1)
    # A stable sort keeps each column's slots in slot order, so that the
    # kernel's segment sums, and hence its results, are the same every call.
    sorted_cols, perm = torch.sort(cols.reshape(-1)[keep], stable=True)
    uniq, counts = torch.unique_consecutive(sorted_cols, return_counts=True)
    seg = torch.zeros((uniq.shape[0] + 1,), dtype=torch.int32, device=dev)
    seg[1:] = torch.cumsum(counts, 0)
    node_map = torch.full((n_nodes,), -1, dtype=torch.int32, device=dev)
    node_map[uniq.long()] = torch.arange(uniq.shape[0], dtype=torch.int32,
                                         device=dev)
    return ColumnIndex(uniq=uniq.to(torch.int32),
                       order=keep[perm].to(torch.int32), seg=seg,
                       node_map=node_map, shape=tuple(cols.shape))
