"""Graphs and signals of the configurations, built in NumPy on the host.

Frozen copies of ``repro_torch.graphs.generators`` (``ring``,
``knn_sphere``), ``repro_torch.graphs.formats.from_edges`` and
``repro_torch.graphs.signals`` (``smooth_periodic_ring``,
``wind_field_sphere``): the same arithmetic, so the same arguments give the
same arrays.  A graph is returned as its padded ELL arrays
``(neighbors int32[N, D], weights float32[N, D], deg int32[N])``, which the
harness hands to the program and to the reference alike.

``knn_sphere`` needs SciPy's ``cKDTree`` and raises without it: the
generator's O(N²) fallback would take hours at the configurations' sizes.
"""
from __future__ import annotations

import numpy as np


def from_edges(edges: np.ndarray, n_nodes: int, normalize: bool = True):
    """Padded ELL arrays of the undirected graph with these edges.

    Symmetrised, duplicate directed edges dropped (first kept), weights 1,
    normalised to D^{-1/2} W D^{-1/2} when ``normalize``."""
    edges = np.asarray(edges, dtype=np.int64)
    weights = np.ones(len(edges), dtype=np.float64)
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    w = np.concatenate([weights, weights])
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
    order = np.argsort(src, kind="stable")
    src_s, dst_s, w_s = src[order], dst[order], w[order]
    row_start = np.zeros(n_nodes, dtype=np.int64)
    row_start[1:] = np.cumsum(deg)[:-1]
    slot = np.arange(len(src_s)) - row_start[src_s]
    neighbors[src_s, slot] = dst_s
    wmat[src_s, slot] = w_s
    return neighbors, wmat, deg.astype(np.int32)


def ring(n_nodes: int, k: int = 1):
    """Ring connecting each node to its k nearest neighbours each side."""
    idx = np.arange(n_nodes)
    edges = [np.stack([idx, (idx + off) % n_nodes], axis=1)
             for off in range(1, k + 1)]
    return from_edges(np.concatenate(edges), n_nodes)


def sphere_points(n_nodes: int, seed: int) -> np.ndarray:
    """Quasi-uniform points on S² (Fibonacci sphere plus jitter), [N, 3]."""
    rng = np.random.default_rng(seed)
    i = np.arange(n_nodes) + 0.5
    phi = np.arccos(1 - 2 * i / n_nodes)
    theta = np.pi * (1 + 5**0.5) * i
    xyz = np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                    np.cos(phi)], axis=1)
    xyz += 0.01 * rng.standard_normal(xyz.shape)
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    return xyz


def knn_sphere(n_nodes: int, k: int = 6, seed: int = 0):
    """k-NN graph over :func:`sphere_points`; returns (ELL arrays, xyz)."""
    from scipy.spatial import cKDTree   # no O(N²) fallback: fail loudly

    xyz = sphere_points(n_nodes, seed)
    _, nbr = cKDTree(xyz).query(xyz, k=k + 1)
    nbr = nbr[:, 1:]
    src = np.repeat(np.arange(n_nodes), k)
    edges = np.stack([src, nbr.reshape(-1)], axis=1)
    return from_edges(edges, n_nodes), xyz


def smooth_periodic_ring(n_nodes: int, harmonics: int = 3,
                         seed: int = 0) -> np.ndarray:
    """Smooth periodic function on a ring (the paper's App. C.2 signal)."""
    rng = np.random.default_rng(seed)
    t = 2 * np.pi * np.arange(n_nodes) / n_nodes
    y = np.zeros(n_nodes)
    for h in range(1, harmonics + 1):
        a, b = rng.standard_normal(2) / h
        y += a * np.sin(h * t) + b * np.cos(h * t)
    return (y - y.mean()) / (y.std() + 1e-12)


def wind_field_sphere(xyz: np.ndarray, seed: int = 0) -> np.ndarray:
    """Smooth scalar 'wind speed' field on S² (the ERA5 stand-in)."""
    rng = np.random.default_rng(seed)
    y = np.zeros(len(xyz))
    for _ in range(4):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        y += rng.uniform(0.3, 1.0) * np.maximum(xyz @ axis, 0.0) ** 2
    return (y - y.mean()) / (y.std() + 1e-12)


def track_nodes(xyz: np.ndarray, amp: float, freq: float,
                width: float) -> np.ndarray:
    """Nodes on a satellite-like track, |amp·sin(freq·λ) − sin φ| < width
    (the wind example's observation rule), ascending."""
    lon = np.arctan2(xyz[:, 1], xyz[:, 0])
    lat = np.arcsin(np.clip(xyz[:, 2], -1, 1))
    return np.where(np.abs(np.sin(freq * lon) * amp - np.sin(lat)) < width)[0]
