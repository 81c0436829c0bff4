"""Padded-ELL graph container (port of ``repro/graphs/formats.py``).

Adjacency is stored as ``neighbors[N, max_deg]`` / ``weights[N, max_deg]``
with zero-weight padding — the layout the walk-sampling kernel reads.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as _device


@dataclasses.dataclass(frozen=True)
class Graph:
    """Padded adjacency-list representation of an undirected weighted graph.

    Attributes:
      neighbors: int32[N, max_deg] — padded with 0 beyond ``deg[i]``.
      weights:   float32[N, max_deg] — walk-matrix entries; 0 beyond ``deg[i]``.
      deg:       int32[N] — unweighted node degrees (Alg. 2's ``d``).
    """

    neighbors: torch.Tensor
    weights: torch.Tensor
    deg: torch.Tensor

    @property
    def n_nodes(self) -> int:
        return self.neighbors.shape[0]

    @property
    def max_deg(self) -> int:
        return self.neighbors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.neighbors.device


def from_edges(
    edges: np.ndarray,
    n_nodes: int,
    weights: np.ndarray | None = None,
    normalize: bool = True,
    device: str | torch.device | None = None,
) -> Graph:
    """Build a :class:`Graph` from an undirected edge list.

    The ELL arrays are built in numpy exactly as the JAX package builds them
    and then moved to ``device`` (default: the CUDA card).

    Args:
      edges: int array [E, 2]; each row an undirected edge (i, j), i != j.
      n_nodes: number of nodes N.
      weights: optional float array [E]; defaults to 1.
      normalize: store the normalised adjacency ``D_w^{-1/2} W D_w^{-1/2}``
        (True) or the raw W.
    """
    dev = _device.resolve(device)
    edges = np.asarray(edges, dtype=np.int64)
    if weights is None:
        weights = np.ones(len(edges), dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    # Symmetrise.
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    w = np.concatenate([weights, weights])
    # Drop duplicate directed edges (keep first).
    key = src * n_nodes + dst
    _, idx = np.unique(key, return_index=True)
    src, dst, w = src[idx], dst[idx], w[idx]

    if normalize:
        wdeg = np.zeros(n_nodes)
        np.add.at(wdeg, src, w)
        scale = 1.0 / np.sqrt(np.maximum(wdeg, 1e-30))
        w = w * scale[src] * scale[dst]

    deg = np.zeros(n_nodes, dtype=np.int64)
    np.add.at(deg, src, 1)
    max_deg = int(deg.max()) if len(deg) else 1
    neighbors = np.zeros((n_nodes, max_deg), dtype=np.int32)
    wmat = np.zeros((n_nodes, max_deg), dtype=np.float32)
    # Vectorised ELL fill: group edges by row, then each edge's slot is its
    # rank within the row.
    order = np.argsort(src, kind="stable")
    src_s, dst_s, w_s = src[order], dst[order], w[order]
    row_start = np.zeros(n_nodes, dtype=np.int64)
    row_start[1:] = np.cumsum(deg)[:-1]
    slot = np.arange(len(src_s)) - row_start[src_s]
    neighbors[src_s, slot] = dst_s
    wmat[src_s, slot] = w_s
    return Graph(
        neighbors=torch.from_numpy(neighbors).to(dev),
        weights=torch.from_numpy(wmat).to(dev),
        deg=torch.from_numpy(deg.astype(np.int32)).to(dev),
    )


def to_dense(graph: Graph) -> torch.Tensor:
    """Dense walk matrix (normalised adjacency) — small-N testing only."""
    n = graph.n_nodes
    dense = torch.zeros((n, n), dtype=torch.float32, device=graph.device)
    rows = torch.arange(n, device=graph.device).repeat_interleave(graph.max_deg)
    cols = graph.neighbors.reshape(-1).long()
    dense.index_put_((rows, cols), graph.weights.reshape(-1), accumulate=True)
    return dense


def normalized_laplacian(graph: Graph) -> torch.Tensor:
    """L̃ = I − Ã for a graph stored with ``normalize=True`` (small-N only)."""
    a = to_dense(graph)
    return torch.eye(graph.n_nodes, dtype=a.dtype, device=a.device) - a
