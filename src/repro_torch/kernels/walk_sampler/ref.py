"""Plain PyTorch version of the walk-sampler kernel.

Port of ``repro/kernels/walk_sampler/ref.py:36`` (``walk_block``).  Each of
``n_walkers`` walkers per start node takes ``l_max`` moves; step l deposits
(current node, load·alive, l) into ELL slot w·(l_max+1)+l.  Halting is
geometric with probability ``p_halt`` per step (masked, never early-exited);
``reweight`` applies d/(1−p_halt) per move; ``scheme`` selects the halt
stream (``grfspp`` replaces it by the weight (1−p_halt)^l).

The float arithmetic follows what XLA compiles the JAX reference to, so
loads agree bit for bit: XLA rewrites a division by a constant into a
multiplication by its float32 reciprocal, so a move is
``((load·d)·inv_c)·w`` with ``inv_c = 1/f32(1−p_halt)`` and the final
``/ n_walkers`` is ``· (1/f32(n_walkers))``.  :func:`step_constants` holds
those constants; the CUDA kernel receives the same values.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rng


def step_constants(n_walkers: int, p_halt: float, l_max: int):
    """(inv_c, p_halt_f32, inv_n, step_weights) as float32 numpy scalars.

    ``step_weights[l] = f32((1−p_halt)^l)`` is computed in double, as the
    JAX reference's Python-scalar ``(1.0 - p_halt) ** step`` is."""
    c = np.float32(1.0 - p_halt)
    inv_c = np.float32(1.0) / c
    inv_n = np.float32(1.0) / np.float32(n_walkers)
    weights = np.array([(1.0 - p_halt) ** s for s in range(l_max + 1)],
                       dtype=np.float32)
    return inv_c, np.float32(p_halt), inv_n, weights


def walk_block(
    neighbors: torch.Tensor,   # int32[N, D] padded adjacency
    weights: torch.Tensor,     # float32[N, D] walk-matrix entries
    deg: torch.Tensor,         # int32[N]
    nodes: torch.Tensor,       # int32[M] absolute start-node ids
    seed: int,                 # uint32 seed
    *,
    n_walkers: int,
    p_halt: float,
    l_max: int,
    reweight: bool = True,
    scheme: str = "iid",
):
    """Sample walks for ``nodes``; returns (cols, loads, lens), each [M, K].

    K = n_walkers·(l_max+1); loads are already divided by n_walkers."""
    if scheme not in rng.SCHEMES:
        raise ValueError(f"unknown walk scheme {scheme!r}; valid: {rng.SCHEMES}")
    dev = neighbors.device
    m = nodes.shape[0]
    max_deg = neighbors.shape[1]
    nbr_flat = neighbors.reshape(-1)
    wgt_flat = weights.reshape(-1)
    inv_c, p32, inv_n, step_w = (
        torch.tensor(x, device=dev) for x in step_constants(n_walkers, p_halt,
                                                            l_max)
    )

    node_u = nodes.to(torch.int64)[:, None]                   # [M, 1]
    walker_u = torch.arange(n_walkers, dtype=torch.int64, device=dev)[None, :]

    cur = nodes.to(torch.int64)[:, None].expand(m, n_walkers)
    load = torch.ones((m, n_walkers), dtype=torch.float32, device=dev)
    alive = torch.ones((m, n_walkers), dtype=torch.float32, device=dev)

    cols_steps, loads_steps = [], []
    for step in range(l_max + 1):
        cols_steps.append(cur)
        if scheme == "grfspp":
            loads_steps.append(load * alive * step_w[step])
        else:
            loads_steps.append(load * alive)
        u_choice = rng.counter_uniform(seed, node_u, walker_u, 2 * step)
        d = deg[cur]                                          # [M, W]
        # Guard isolated nodes: degree 0 ⇒ stay on padding with zero load.
        choice = torch.minimum(
            (u_choice * d.to(torch.float32)).to(torch.int64),
            torch.clamp(d.to(torch.int64) - 1, min=0),
        )
        flat = cur * max_deg + choice
        nxt = nbr_flat[flat].to(torch.int64)
        w = wgt_flat[flat]
        if reweight:
            load = load * d.to(torch.float32) * inv_c * w
        else:
            load = load * w
        if scheme != "grfspp":
            u_halt = rng.halt_uniform(seed, node_u, walker_u, 2 * step + 1,
                                      scheme=scheme)
            alive = alive * (u_halt >= p32).to(torch.float32)
        alive = alive * (d > 0).to(torch.float32)
        cur = nxt

    k = n_walkers * (l_max + 1)
    cols = torch.stack(cols_steps, dim=-1).reshape(m, k).to(torch.int32)
    loads = (torch.stack(loads_steps, dim=-1) * inv_n).reshape(m, k)
    lens = torch.arange(l_max + 1, dtype=torch.int32, device=dev).expand(
        m, n_walkers, l_max + 1).reshape(m, k)
    return cols, loads, lens


# The plain version is the whole problem as one block.
walk_sample_ref = walk_block


def walk_sample_vals_ref(neighbors, weights, deg, nodes, f, n_valid: int,
                         seed: int, **kw):
    """(cols, vals) of the kernel's ``walk_sample_vals_launch``: the walks
    of :func:`walk_block`, then vals = (loads·valid)·f[lens] with valid 0 on
    rows ``n_valid`` and past."""
    cols, loads, lens = walk_block(neighbors, weights, deg, nodes, seed, **kw)
    valid = (torch.arange(nodes.shape[0], device=loads.device)
             < n_valid).to(torch.float32)
    return cols, (loads * valid[:, None]).to(f.dtype) * f[lens]
