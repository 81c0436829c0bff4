"""GRF feature-matrix operations (port of ``repro/core/features.py``).

Φ ∈ R^{M×N} is stored as a :class:`WalkTrace` (ELL: cols/loads/lens) plus a
modulation vector ``f``.  All products are O(M·K), K = n·(l_max+1):

  * ``phi_matvec``     y = Φ u          (gather-reduce over slots)
  * ``phi_t_matvec``   u = Φᵀ v         (scatter-add over slots)
  * ``khat_matvec``    y = K̂ v = Φ(Φᵀv) (Thm. 2: O(N) matvec)

Every product goes through ``kernels.dispatch`` (CUDA kernel on the card,
plain version on the CPU).  The chunked drivers re-sample ``chunk``-row
blocks of walks for each product (counter RNG ⇒ the same rows as the
monolithic trace), so peak memory is O(chunk·K) instead of O(N·K); the JAX
``lax.scan`` over chunks is a Python loop here.
"""
from __future__ import annotations

import torch

from .. import obs
from ..graphs.formats import Graph
from ..kernels import dispatch
from .walks import WalkConfig, WalkTrace


def feature_values(trace: WalkTrace, f: torch.Tensor) -> torch.Tensor:
    """vals[i,k] = loads[i,k] * f[lens[i,k]] — the GRF entries (Alg. 1 line 8).

    ``index_select`` rather than ``f[lens]``: its backward is an atomic
    ``index_add_``, while advanced indexing backpropagates through a
    sort-based accumulate that serialises on the l_max+1 distinct lengths
    (most of the fit's device time on the card; PERF.md).  A compact trace
    (int8 lens, bf16 loads: the dry run's GRF-GP cell) is widened here."""
    lens = trace.lens
    idx = lens.reshape(-1)
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.to(torch.int32)
    return trace.loads.to(f.dtype) * torch.index_select(f, 0, idx).reshape(lens.shape)


def phi_matvec(trace: WalkTrace, f: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y = Φ u.  u: [N] or [N, R] → y: [M] or [M, R]."""
    return dispatch.phi_matvec(feature_values(trace, f), trace.cols, u)


def phi_t_matvec(
    trace: WalkTrace, f: torch.Tensor, v: torch.Tensor, n_nodes: int
) -> torch.Tensor:
    """u = Φᵀ v.  v: [M] or [M, R] → u: [n_nodes] or [n_nodes, R]."""
    return dispatch.phi_t_matvec(feature_values(trace, f), trace.cols, v,
                                 n_nodes)


def khat_matvec(trace: WalkTrace, f: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = K̂ v = Φ (Φᵀ v) for square Φ (M == N)."""
    vals = feature_values(trace, f)
    n = trace.n_nodes
    return dispatch.khat_matvec(vals, trace.cols, vals, trace.cols, v, n,
                                trace.column_index(n))


def khat_cross_matvec(
    trace_rows: WalkTrace, trace_cols: WalkTrace, f: torch.Tensor,
    v: torch.Tensor, n_nodes: int,
) -> torch.Tensor:
    """y = K̂[rows, cols] v = Φ_rows (Φ_colsᵀ v) — e.g. K̂_{·,x} in Eq. 12."""
    return dispatch.khat_matvec(
        feature_values(trace_rows, f), trace_rows.cols,
        feature_values(trace_cols, f), trace_cols.cols,
        v, n_nodes, trace_cols.column_index(n_nodes),
    )


def take_rows(trace: WalkTrace, rows: torch.Tensor) -> WalkTrace:
    """Row-subset of Φ (training-node features Φ_x); the
    ``features.take_rows`` span."""
    with obs.span("features.take_rows"):
        rows = rows.long()
        return WalkTrace(cols=trace.cols[rows], loads=trace.loads[rows],
                         lens=trace.lens[rows])


def materialize_phi(trace: WalkTrace, f: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Dense Φ [M, n_nodes] — small problems and tests only."""
    vals = feature_values(trace, f)
    m = trace.cols.shape[0]
    out = torch.zeros((m, n_nodes), dtype=vals.dtype, device=vals.device)
    rows = torch.arange(m, device=vals.device).repeat_interleave(trace.slots)
    out.index_put_((rows, trace.cols.reshape(-1).long()), vals.reshape(-1),
                   accumulate=True)
    return out


def materialize_khat(trace: WalkTrace, f: torch.Tensor,
                     n_nodes: int | None = None) -> torch.Tensor:
    """Dense K̂ = ΦΦᵀ — the paper's 'GRFs (Dense)' baseline (Table 1)."""
    n_nodes = trace.n_nodes if n_nodes is None else n_nodes
    phi = materialize_phi(trace, f, n_nodes)
    return phi @ phi.T


def khat_diag_approx(trace: WalkTrace, f: torch.Tensor) -> torch.Tensor:
    """Σ_k vals² per row: a lower bound on diag(K̂) that ignores duplicate
    columns — the Jacobi preconditioner diagonal (any SPD approximation is
    valid there)."""
    vals = feature_values(trace, f)
    return torch.sum(vals * vals, dim=1)


def nnz_per_row(trace: WalkTrace) -> torch.Tensor:
    """Number of distinct non-zero entries per feature row (Thm. 1
    sparsity): the distinct columns among the slots with a non-zero load,
    as int32.  Each row's live columns are sorted, so the cost is
    O(M·K log K) and no [M, K, K] comparison block is built."""
    marked = torch.where(trace.loads != 0, trace.cols.long(),
                         torch.full_like(trace.cols, -1, dtype=torch.long))
    s = torch.sort(marked, dim=1).values
    new = torch.ones_like(s, dtype=torch.bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    return torch.sum(new & (s >= 0), dim=1).to(torch.int32)


def khat_diag_exact(trace: WalkTrace, f: torch.Tensor) -> torch.Tensor:
    """Exact diag(K̂)_i = ‖φ(i)‖² accounting for duplicate columns; O(M·K²)."""
    vals = feature_values(trace, f)
    same = trace.cols[:, :, None] == trace.cols[:, None, :]
    return torch.einsum("mk,ml,mkl->m", vals, vals, same.to(vals.dtype))


# ---------------------------------------------------------------------------
# Chunked products: Φ is never materialised.  Each step re-samples a
# `chunk`-row block of walks and streams it straight into the product.
# ---------------------------------------------------------------------------


def _sample_chunk_vals(graph, f, seed, start, chunk, n_rows, cfg):
    """Sample one block; returns (cols, vals) with padded rows zeroed."""
    dev = graph.device
    idx = torch.arange(chunk, device=dev)
    valid = (idx < n_rows).to(torch.float32)
    nodes = torch.clamp(start + idx, max=graph.n_nodes - 1).to(torch.int32)
    cols, loads, lens = dispatch.walk_sample(
        graph.neighbors, graph.weights, graph.deg, nodes, seed,
        n_walkers=cfg.n_walkers, p_halt=cfg.p_halt, l_max=cfg.l_max,
        reweight=cfg.reweight, scheme=cfg.scheme,
    )
    vals = (loads * valid[:, None]).to(f.dtype) * f[lens]
    return cols, vals


def phi_matvec_chunked(
    graph: Graph, f: torch.Tensor, u: torch.Tensor, seed: int,
    *, cfg: WalkConfig, chunk: int, row_start: int = 0,
    n_rows: int | None = None,
) -> torch.Tensor:
    """y = Φ u over rows [row_start, row_start+n_rows), streamed by chunks."""
    n_rows = graph.n_nodes if n_rows is None else n_rows
    nc = -(-n_rows // chunk)
    y = torch.zeros((nc * chunk,) + tuple(u.shape[1:]), dtype=torch.float32,
                    device=u.device)
    for i in range(nc):
        cols, vals = _sample_chunk_vals(
            graph, f, seed, row_start + i * chunk, chunk, n_rows - i * chunk,
            cfg,
        )
        y[i * chunk:(i + 1) * chunk] = dispatch.phi_matvec(vals, cols, u)
    return y[:n_rows]


def phi_t_matvec_chunked(
    graph: Graph, f: torch.Tensor, v: torch.Tensor, seed: int,
    *, cfg: WalkConfig, chunk: int, row_start: int = 0,
    n_rows: int | None = None,
) -> torch.Tensor:
    """u = Φᵀ v for the same streamed row range; accumulates into [N(, R)]
    (in place: each chunk's scatter is added to one running sum)."""
    n_rows = graph.n_nodes if n_rows is None else n_rows
    nc = -(-n_rows // chunk)
    pad = nc * chunk - n_rows
    if pad:
        v = torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
    u = torch.zeros((graph.n_nodes,) + tuple(v.shape[1:]), dtype=torch.float32,
                    device=v.device)
    for i in range(nc):
        cols, vals = _sample_chunk_vals(
            graph, f, seed, row_start + i * chunk, chunk, n_rows - i * chunk,
            cfg,
        )
        u += dispatch.phi_t_matvec(vals, cols, v[i * chunk:(i + 1) * chunk],
                                   graph.n_nodes)
    return u


def khat_diag_approx_chunked(
    graph: Graph, f: torch.Tensor, seed: int,
    *, cfg: WalkConfig, chunk: int, row_start: int = 0,
    n_rows: int | None = None,
) -> torch.Tensor:
    """Streamed Σ_k vals² per row — the Jacobi diagonal without the trace."""
    n_rows = graph.n_nodes if n_rows is None else n_rows
    nc = -(-n_rows // chunk)
    d = torch.zeros((nc * chunk,), dtype=torch.float32, device=graph.device)
    for i in range(nc):
        _, vals = _sample_chunk_vals(
            graph, f, seed, row_start + i * chunk, chunk, n_rows - i * chunk,
            cfg,
        )
        d[i * chunk:(i + 1) * chunk] = torch.sum(vals * vals, dim=1)
    return d[:n_rows]
