"""Wrapper of the walk-sampler CUDA kernel (``csrc/walk_sampler.cu``).

On CPU tensors it runs the plain version (ref.py); on CUDA tensors it
launches the kernel on PyTorch's current stream, or raises.  No custom
autograd: sampling produces the integer/load structure of the trace, and
differentiability w.r.t. the modulation lives in ``core.features``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import step_constants, walk_sample_ref
from .rng import SCHEMES

# Kernel launches since the last reset (chip_smoke.py reads it).
LAUNCHES = {"walk_sampler": 0}

MAX_STEPS = 64  # StepWeights capacity in walk_sampler.cu

_ARGTYPES = [ctypes.c_void_p] * 7 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
]


def walk_sample(
    neighbors: torch.Tensor, weights: torch.Tensor, deg: torch.Tensor,
    nodes: torch.Tensor, seed: int,
    *, n_walkers: int, p_halt: float, l_max: int, reweight: bool = True,
    scheme: str = "iid",
):
    """(cols, loads, lens), each [M, n_walkers·(l_max+1)], for ``nodes``."""
    name = "walk_sampler"
    if scheme not in SCHEMES:
        raise ValueError(f"unknown walk scheme {scheme!r}; valid: {SCHEMES}")
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"{name}: seed must be a uint32, got {seed}")
    if not build.on_cuda(name, neighbors, weights, deg, nodes):
        return walk_sample_ref(
            neighbors, weights, deg, nodes, seed, n_walkers=n_walkers,
            p_halt=p_halt, l_max=l_max, reweight=reweight, scheme=scheme,
        )
    build.check(name, neighbors, "neighbors", (torch.int32,), (2,))
    build.check(name, weights, "weights", (torch.float32,), (2,))
    build.check(name, deg, "deg", (torch.int32,), (1,))
    build.check(name, nodes, "nodes", (torch.int32,), (1,))
    if weights.shape != neighbors.shape or deg.shape[0] != neighbors.shape[0]:
        raise ValueError(f"{name}: neighbors/weights/deg shapes disagree")
    if neighbors.shape[1] < 1:
        raise ValueError(f"{name}: adjacency needs max_deg >= 1")
    if not 0 <= l_max < MAX_STEPS:
        raise ValueError(f"{name}: l_max must be in [0, {MAX_STEPS - 1}]")
    if n_walkers < 1:
        raise ValueError(f"{name}: n_walkers must be >= 1")

    dev = nodes.device
    m, k = nodes.shape[0], n_walkers * (l_max + 1)
    cols = torch.empty((m, k), dtype=torch.int32, device=dev)
    loads = torch.empty((m, k), dtype=torch.float32, device=dev)
    lens = torch.empty((m, k), dtype=torch.int32, device=dev)
    inv_c, p32, inv_n, step_w = step_constants(n_walkers, p_halt, l_max)
    sw = (ctypes.c_float * (l_max + 1))(*step_w.tolist())
    fn = build.bind(name, "walk_sample_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        fn(build.ptr(neighbors), build.ptr(weights), build.ptr(deg),
           build.ptr(nodes), build.ptr(cols), build.ptr(loads),
           build.ptr(lens), m, neighbors.shape[1], n_walkers, l_max,
           int(seed), SCHEMES.index(scheme), int(bool(reweight)),
           float(inv_c), float(p32), float(inv_n), sw, build.stream(dev))
    LAUNCHES[name] += 1
    return cols, loads, lens
