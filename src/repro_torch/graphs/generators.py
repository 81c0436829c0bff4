"""Graph generators (port of ``repro/graphs/generators.py``).

The edge lists are built in numpy exactly as in the JAX package, so for the
same arguments and seed the ELL arrays are identical; only the final move to
``device`` (default: the CUDA card) differs.
"""
from __future__ import annotations

import numpy as np
import torch

from .formats import Graph, from_edges

Device = str | torch.device | None


def ring(n_nodes: int, k: int = 1, normalize: bool = True,
         device: Device = None) -> Graph:
    """Ring graph connecting each node to its k nearest neighbours each side."""
    idx = np.arange(n_nodes)
    edges = []
    for off in range(1, k + 1):
        edges.append(np.stack([idx, (idx + off) % n_nodes], axis=1))
    return from_edges(np.concatenate(edges), n_nodes, normalize=normalize,
                      device=device)


def grid2d(rows: int, cols: int, normalize: bool = True,
           device: Device = None) -> Graph:
    """rows×cols 4-connected mesh."""
    def nid(r, c):
        return r * cols + c

    edges = []
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                edges.append((nid(r, c), nid(r, c + 1)))
            if r + 1 < rows:
                edges.append((nid(r, c), nid(r + 1, c)))
    return from_edges(np.array(edges), rows * cols, normalize=normalize,
                      device=device)


def community_sbm(
    n_nodes: int,
    n_communities: int,
    p_in: float,
    p_out: float,
    seed: int = 0,
    normalize: bool = True,
    device: Device = None,
) -> tuple[Graph, np.ndarray]:
    """Stochastic block model; returns (graph, community labels)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_communities, size=n_nodes)
    edges = []
    # Sample blockwise to avoid O(N^2) memory for large N.
    order = np.argsort(labels)
    labels_sorted = labels[order]
    for a in range(n_communities):
        for b in range(a, n_communities):
            ia = order[labels_sorted == a]
            ib = order[labels_sorted == b]
            p = p_in if a == b else p_out
            if p <= 0 or len(ia) == 0 or len(ib) == 0:
                continue
            n_pairs = len(ia) * len(ib)
            n_draw = rng.binomial(n_pairs, p)
            if n_draw == 0:
                continue
            flat = rng.choice(n_pairs, size=min(n_draw, n_pairs), replace=False)
            src = ia[flat // len(ib)]
            dst = ib[flat % len(ib)]
            mask = src != dst
            edges.append(np.stack([src[mask], dst[mask]], axis=1))
    edges = np.concatenate(edges) if edges else np.zeros((0, 2), np.int64)
    g = _ensure_connected(edges, n_nodes, rng)
    return from_edges(g, n_nodes, normalize=normalize, device=device), labels


def knn_sphere(
    n_nodes: int, k: int = 6, seed: int = 0, normalize: bool = True,
    device: Device = None,
) -> tuple[Graph, np.ndarray]:
    """k-NN graph over quasi-uniform points on S² (ERA5 wind stand-in).

    Returns (graph, xyz coordinates [N, 3]).
    """
    rng = np.random.default_rng(seed)
    # Fibonacci sphere + jitter: quasi-uniform like a lat/lon discretisation.
    i = np.arange(n_nodes) + 0.5
    phi = np.arccos(1 - 2 * i / n_nodes)
    theta = np.pi * (1 + 5**0.5) * i
    xyz = np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
        axis=1,
    )
    xyz += 0.01 * rng.standard_normal(xyz.shape)
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    try:
        from scipy.spatial import cKDTree

        tree = cKDTree(xyz)
        _, nbr = tree.query(xyz, k=k + 1)
        nbr = nbr[:, 1:]
    except ImportError:  # pragma: no cover
        d2 = ((xyz[:, None] - xyz[None]) ** 2).sum(-1)
        nbr = np.argsort(d2, axis=1)[:, 1 : k + 1]
    src = np.repeat(np.arange(n_nodes), k)
    edges = np.stack([src, nbr.reshape(-1)], axis=1)
    return from_edges(edges, n_nodes, normalize=normalize, device=device), xyz


def barabasi_albert(
    n_nodes: int, m: int = 3, seed: int = 0, normalize: bool = True,
    device: Device = None,
) -> Graph:
    """Preferential-attachment graph (SNAP social-network stand-in)."""
    rng = np.random.default_rng(seed)
    targets = list(range(m))
    repeated: list[int] = list(range(m))
    edges = []
    for v in range(m, n_nodes):
        for t in targets:
            edges.append((v, t))
        repeated.extend(targets)
        repeated.extend([v] * m)
        targets = [repeated[j] for j in rng.integers(0, len(repeated), size=m)]
        # dedupe targets while keeping count m
        targets = list(dict.fromkeys(targets))
        while len(targets) < m:
            cand = int(repeated[rng.integers(0, len(repeated))])
            if cand not in targets:
                targets.append(cand)
    return from_edges(np.array(edges), n_nodes, normalize=normalize,
                      device=device)


def _ensure_connected(edges: np.ndarray, n_nodes: int, rng) -> np.ndarray:
    """Append a random spanning chain so no node is isolated."""
    perm = rng.permutation(n_nodes)
    chain = np.stack([perm[:-1], perm[1:]], axis=1)
    return np.concatenate([edges, chain]) if len(edges) else chain
