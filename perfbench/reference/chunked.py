"""Eq. 12 over every node of a graph whose walk trace is not held: the
reference of the chunked posterior, in float64.

Φ's rows are streamed in row blocks, each sampled by the reference walks
(:mod:`perfbench.reference.walks`) and held as a :class:`gp.Features`
block; only the training rows Φ_x are kept.  The order is the
reference's own, not the program's: g_x = Φ_x w is taken from Φ_x, the
solve runs on Φ_x alone, and one streamed pass gives every sample at once,
g + K̂_{·x}v = Φ(w + Φ_xᵀv).  The same pass counts the problem's sizes
that the work counts read.
"""
from __future__ import annotations

import math

import torch

from perfbench.reference import gp, walks as ref_walks

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Graph:
    """The graph arrays and the walk widths the reference samples with."""

    def __init__(self, neighbors, weights, deg, seed: int, n_walkers: int,
                 p_halt: float, l_max: int):
        self.neighbors, self.weights, self.deg = neighbors, weights, deg
        self.n = int(deg.shape[0])
        self.seed = seed
        self.walk = (n_walkers, p_halt, l_max)

    def features(self, nodes: torch.Tensor, f: torch.Tensor):
        """(gp.Features, cols, loads) of the rows ``nodes``."""
        cols, loads, lens = ref_walks.sample(
            self.neighbors, self.weights, self.deg, nodes, self.seed,
            *self.walk)
        return gp.Features(cols, loads, lens, f, self.n), cols, loads


def stream(g: Graph, f: torch.Tensor, x: torch.Tensor, block: int,
           x_cols: torch.Tensor | None = None):
    """(Φx [N, R] float64, sizes or None), Φ's rows sampled ``block`` at a
    time.  With ``x_cols`` (bool [N], the columns Φ_x touches) the pass
    also counts the whole trace's live slots (``nnz``), the distinct
    columns they touch (``touched``) and the slots that land on a column
    of Φ_x (``hits_x``)."""
    dev = x.device
    out = torch.empty((g.n, x.shape[1]), dtype=gp.F64, device=dev)
    touched = None if x_cols is None else torch.zeros_like(x_cols)
    nnz = hits = 0
    for s in range(0, g.n, block):
        nodes = torch.arange(s, min(s + block, g.n), dtype=torch.int32,
                             device=dev)
        phi, cols, loads = g.features(nodes, f)
        out[s:s + nodes.shape[0]] = phi.matvec(x)
        if x_cols is not None:
            live = cols[loads != 0].long()
            nnz += live.numel()
            touched[live] = True
            hits += int(x_cols[live].sum())
        del phi, cols, loads
    if x_cols is None:
        return out, None
    return out, {"nnz": nnz, "touched": int(touched.sum()), "hits_x": hits}


def pathwise_samples(g: Graph, f: torch.Tensor, train: torch.Tensor, y,
                     draws, sigma2: float, tol: float, max_iters: int,
                     block: int, sizes: bool = False):
    """Eq. 12 for each (w [N, S], eps [T, S]) of ``draws``, solved exactly
    to float64: ([N, S] float64 samples a draw, sizes or None).  ``sizes``
    adds the problem's sizes (:func:`stream`'s, and Φ_x's own)."""
    phi_x, cols_x, loads_x = g.features(train, f)
    xs = []
    for w, eps in draws:
        resid = y[:, None] - (phi_x.matvec(w) + math.sqrt(sigma2) * eps)
        v, _ = gp.cg(lambda p: phi_x.khat(p) + sigma2 * p, resid, tol,
                     max_iters)
        xs.append(w + phi_x.rmatvec(v))
    x = torch.cat(xs, dim=1)
    del xs
    x_cols = None
    if sizes:
        live_x = cols_x[loads_x != 0].long()
        x_cols = torch.zeros(g.n, dtype=torch.bool, device=x.device)
        x_cols[live_x] = True
    out, counts = stream(g, f, x, block, x_cols)
    if counts is not None:
        counts.update(k=int(cols_x.shape[1]), nnz_x=int(live_x.numel()),
                      touched_x=int(x_cols.sum()))
    return list(out.split(x.shape[1] // len(draws), dim=1)), counts
