"""GRF random walks (the paper's Alg. 2), frozen copy of the port's plain
sampler (``repro_torch/kernels/walk_sampler/{rng,ref}.py``, "iid" scheme).

A murmur3-style counter hash keyed on (seed, start node, walker, counter)
drives every draw, so a node's walks depend only on its absolute id.  The
hash runs on int64 tensors holding uint32 values; products are formed from
16-bit halves of the constant so nothing overflows.  The float arithmetic
is the sampler's float32: a move is ((load·d)·inv_c)·w with
inv_c = 1/f32(1 − p_halt), and loads are scaled by 1/f32(n_walkers).
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_M3 = 0x27D4EB2F
_INV_2_24 = float(2.0**-24)


def _mul32(h: torch.Tensor, const: int) -> torch.Tensor:
    lo = h * (const & 0xFFFF)
    hi = ((h * (const >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def _uniform(seed: int, node: torch.Tensor, walker: torch.Tensor,
             ctr: int) -> torch.Tensor:
    """float32 uniform in [0, 1) from the top 24 bits of the counter hash."""
    h = torch.full_like(node, (seed & _MASK) ^ _GOLDEN)
    h = _fmix32(h ^ _mul32(node & _MASK, _M1))
    h = _fmix32(h ^ _mul32(walker & _MASK, _M2))
    h = _fmix32(h ^ _mul32(torch.full_like(h, ctr & _MASK), _M3))
    return (h >> 8).to(torch.float32) * _INV_2_24


def sample(neighbors: torch.Tensor, weights: torch.Tensor, deg: torch.Tensor,
           nodes: torch.Tensor, seed: int, n_walkers: int, p_halt: float,
           l_max: int, block: int = 1 << 17):
    """(cols int32, loads float32, lens int32), each [M, n_walkers·(l_max+1)],
    for the start ``nodes``; slot w·(l_max+1)+l holds walker w's step l."""
    dev = neighbors.device
    max_deg = neighbors.shape[1]
    nbr = neighbors.reshape(-1)
    wgt = weights.reshape(-1)
    inv_c = torch.tensor(np.float32(1.0) / np.float32(1.0 - p_halt), device=dev)
    p32 = torch.tensor(np.float32(p_halt), device=dev)
    inv_n = torch.tensor(np.float32(1.0) / np.float32(n_walkers), device=dev)
    k = n_walkers * (l_max + 1)
    parts = []
    for start in range(0, nodes.shape[0], block):
        node = nodes[start:start + block].to(torch.int64)[:, None]
        m = node.shape[0]
        walker = torch.arange(n_walkers, dtype=torch.int64, device=dev)[None, :]
        node_b, walker_b = torch.broadcast_tensors(node, walker)
        cur = node_b.clone()
        load = torch.ones((m, n_walkers), dtype=torch.float32, device=dev)
        alive = torch.ones_like(load)
        cols, loads = [], []
        for step in range(l_max + 1):
            cols.append(cur)
            loads.append(load * alive)
            u = _uniform(seed, node_b, walker_b, 2 * step)
            d = deg[cur]
            choice = torch.minimum((u * d.to(torch.float32)).to(torch.int64),
                                   torch.clamp(d.to(torch.int64) - 1, min=0))
            flat = cur * max_deg + choice
            nxt = nbr[flat].to(torch.int64)
            load = load * d.to(torch.float32) * inv_c * wgt[flat]
            halt = _uniform(seed, node_b, walker_b, 2 * step + 1)
            alive = alive * (halt >= p32).to(torch.float32)
            alive = alive * (d > 0).to(torch.float32)
            cur = nxt
        parts.append((torch.stack(cols, -1).reshape(m, k).to(torch.int32),
                      (torch.stack(loads, -1) * inv_n).reshape(m, k)))
    cols = torch.cat([c for c, _ in parts])
    loads = torch.cat([ld for _, ld in parts])
    lens = torch.arange(l_max + 1, dtype=torch.int32, device=dev).repeat(
        n_walkers).expand(cols.shape[0], k).contiguous()
    return cols, loads, lens
