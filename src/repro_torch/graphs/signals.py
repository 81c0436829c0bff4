"""Synthetic ground-truth functions on graphs (port of repro/graphs/signals.py; paper §4, App. C.2/C.6)."""
from __future__ import annotations

import numpy as np


def smooth_periodic_ring(n_nodes: int, harmonics: int = 3, seed: int = 0) -> np.ndarray:
    """Smooth periodic function on a ring (App. C.2 scaling experiments)."""
    rng = np.random.default_rng(seed)
    t = 2 * np.pi * np.arange(n_nodes) / n_nodes
    y = np.zeros(n_nodes)
    for h in range(1, harmonics + 1):
        a, b = rng.standard_normal(2) / h
        y += a * np.sin(h * t) + b * np.cos(h * t)
    return (y - y.mean()) / (y.std() + 1e-12)


def unimodal_grid(rows: int, cols: int) -> np.ndarray:
    """Single smooth central peak on a grid (App. C.6 synthetic benchmark)."""
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    d2 = ((r - rows / 2) / rows) ** 2 + ((c - cols / 2) / cols) ** 2
    return np.exp(-12.0 * d2).reshape(-1)

def multimodal_grid(rows: int, cols: int, n_peaks: int = 5, seed: int = 0) -> np.ndarray:
    """Several randomly placed peaks (App. C.6)."""
    rng = np.random.default_rng(seed)
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    y = np.zeros((rows, cols))
    for _ in range(n_peaks):
        pr, pc = rng.uniform(0, rows), rng.uniform(0, cols)
        amp = rng.uniform(0.5, 1.0)
        y += amp * np.exp(-(((r - pr) / (0.12 * rows)) ** 2 + ((c - pc) / (0.12 * cols)) ** 2))
    return y.reshape(-1)


def community_scores(labels: np.ndarray, seed: int = 0) -> np.ndarray:
    """Community graph objective: node score ~ N(mu_c, sigma_c^2) (App. C.6)."""
    rng = np.random.default_rng(seed)
    n_comm = int(labels.max()) + 1
    mu = rng.uniform(-1, 1, size=n_comm)
    sigma = rng.uniform(0.05, 0.2, size=n_comm)
    return mu[labels] + sigma[labels] * rng.standard_normal(len(labels))


def sinusoid_ring(n_nodes: int, period: int = 4) -> np.ndarray:
    """Sinusoidal function on a circular graph (App. C.6)."""
    t = 2 * np.pi * np.arange(n_nodes) / n_nodes
    return np.sin(period * t)


def wind_field_sphere(xyz: np.ndarray, seed: int = 0) -> np.ndarray:
    """Smooth scalar 'wind speed' field on S² (ERA5 stand-in).

    A few random low-order spherical-harmonic-like lobes.
    """
    rng = np.random.default_rng(seed)
    y = np.zeros(len(xyz))
    for _ in range(4):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        y += rng.uniform(0.3, 1.0) * np.maximum(xyz @ axis, 0.0) ** 2
    return (y - y.mean()) / (y.std() + 1e-12)


def gp_sample_from_dense_kernel(kernel: np.ndarray, seed: int = 0) -> np.ndarray:
    """Exact GP prior draw given a dense kernel (small N; App. C.3 ablation)."""
    rng = np.random.default_rng(seed)
    n = kernel.shape[0]
    jitter = 1e-6 * np.eye(n)
    chol = np.linalg.cholesky(kernel + jitter)
    return chol @ rng.standard_normal(n)
