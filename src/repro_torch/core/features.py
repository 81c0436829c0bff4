"""GRF feature-matrix operations (port of ``repro/core/features.py``).

Φ ∈ R^{M×N} is stored as a :class:`WalkTrace` (ELL: cols/loads/lens) plus a
modulation vector ``f``.  All products are O(M·K), K = n·(l_max+1):

  * ``phi_matvec``     y = Φ u          (gather-reduce over slots)
  * ``phi_t_matvec``   u = Φᵀ v         (scatter-add over slots)
  * ``khat_matvec``    y = K̂ v = Φ(Φᵀv) (Thm. 2: O(N) matvec)
  * ``coalesce``       Φ as one entry per distinct (row, column), the
                       payload the fused K̂ products of a solve read
                       (``coalesced`` keeps it on the trace)

Every product goes through ``kernels.dispatch`` (CUDA kernel on the card,
plain version on the CPU).  The chunked drivers re-sample ``chunk``-row
blocks of walks for each product (counter RNG ⇒ the same rows as the
monolithic trace), so peak memory is O(chunk·K) instead of O(N·K); the JAX
``lax.scan`` over chunks is a Python loop here.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch

from .. import obs
from ..graphs.formats import Graph
from ..kernels import dispatch
from ..kernels.ell_spmv.index import ColumnIndex, column_index
from ..obs import taps as _obs_taps
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


@dataclasses.dataclass(frozen=True)
class Coalesced:
    """Φ with each row's slots that share a column merged (:func:`coalesce`).

    Attributes:
      vals:  float32[M, Kc] each row's distinct entries, the sums of their
             slots' values, in order of first occurrence, then 0.
      cols:  int32[M, Kc] their columns; the padding holds node 0, a valid
             id (the fused kernel maps every slot's column before it tests
             the value).
      index: the column index of its entries (the padding not) over the
             graph's nodes.
    """

    vals: torch.Tensor
    cols: torch.Tensor
    index: ColumnIndex


def coalesce(trace: WalkTrace, f: torch.Tensor, n_nodes: int) -> Coalesced:
    """Φ = (trace, f) as one entry per distinct (row, column), its value the
    sum of the row's slots there: the same matrix up to the order of float32
    sums, in a tenth of the live slots on a walk row (58 of 612 on the wind
    example's track), so a fused K̂ product gathers a tenth of the rows of
    its dense operands.  The rows are aggregated by ``gram_block``'s first
    step; one host read (the largest count and the sum of the counts) cuts
    the payload to Kc, the largest count rounded up to 32, and sizes its
    column index.  With obs on, a
    ``khat.coalesce`` tap records the rows, live slots, kept entries and Kc.
    """
    vals = feature_values(trace, f)
    m, k = vals.shape
    acols, avals, counts = dispatch.aggregate_rows(vals, trace.cols)
    most, kept = (torch.stack([counts.max().long(), counts.sum()]).tolist()
                  if m else (0, 0))
    kc = min(k, -(-most // 32) * 32)
    entry = acols[:, :kc] >= 0
    cols = acols[:, :kc].clamp_min(0).contiguous()
    cvals = avals[:, :kc].contiguous()
    if obs.enabled():
        obs.tap_dict("khat.coalesce", {"rows": m, "live": (vals != 0).sum(),
                                       "kept": kept, "kc": kc})
    # The index lists every entry (the read gave their number, so it finds
    # them without a host read of its own); an entry whose slots summed to
    # exactly 0 adds 0 to a product.
    return Coalesced(cvals, cols, column_index(cols, entry, n_nodes, nnz=kept))


def coalesced(trace: WalkTrace, f: torch.Tensor, n_nodes: int) -> Coalesced:
    """:func:`coalesce` of (trace, f), built on first use and kept on the
    trace beside its column index (``WalkTrace.column_index``).  It depends
    on ``f`` too, so the key holds ``f`` itself, by a weak reference (a
    freed ``f`` never matches, even where the allocator gives its address to
    the next one), with its version and dtype, and the versions of ``cols``,
    ``loads`` and ``lens``.  A build is a ``walks.column_index`` span, as
    the column index's is; a read of the kept payload is none."""
    key = (n_nodes, trace.cols._version, trace.loads._version,
           trace.lens._version, f._version, f.dtype)
    kept = trace.__dict__.get("_coalesced")
    if kept is None or kept[0] != key or kept[1]() is not f:
        with obs.span("walks.column_index"):
            kept = (key, weakref.ref(f), coalesce(trace, f, n_nodes))
        object.__setattr__(trace, "_coalesced", kept)
    return kept[2]


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
    """Sample one block; returns (cols, vals) with padded rows zeroed.  The
    sampling is a ``walks.sample`` span, as each block of
    ``walks.walk_chunks`` is.

    With a float32 f that needs no gradient, the sampler writes vals itself
    (``dispatch.walk_sample_vals``; its plain version on the CPU);
    otherwise (a bf16 f, an f under a fit's gradient) vals is composed from
    the sampled loads and lens.  Each block counts into
    ``walks.chunk_values`` under ``path`` ``"sampler"`` or
    ``"composed"``."""
    dev = graph.device
    idx = torch.arange(chunk, device=dev)
    nodes = torch.clamp(start + idx, max=graph.n_nodes - 1).to(torch.int32)
    walk_kw = dict(n_walkers=cfg.n_walkers, p_halt=cfg.p_halt, l_max=cfg.l_max,
                   reweight=cfg.reweight, scheme=cfg.scheme)
    fused = f.dtype == torch.float32 and not f.requires_grad
    _obs_taps.count("walks.chunk_values",
                    labels={"path": "sampler" if fused else "composed"})
    with obs.span("walks.sample", rows=chunk, scheme=cfg.scheme,
                  chunk_start=start) as sp:
        if fused:
            cols, vals = dispatch.walk_sample_vals(
                graph.neighbors, graph.weights, graph.deg, nodes, f,
                min(n_rows, chunk), seed, **walk_kw)
            sp.block_on((cols, vals))
            return cols, vals
        cols, loads, lens = dispatch.walk_sample(
            graph.neighbors, graph.weights, graph.deg, nodes, seed, **walk_kw)
        sp.block_on((cols, loads, lens))
    valid = (idx < n_rows).to(torch.float32)
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
