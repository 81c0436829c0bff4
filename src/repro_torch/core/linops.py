"""Linear operators of the GRF sparse stack (port of ``repro/core/linops.py``).

  * :class:`PhiOperator`        Φ — walk trace + modulation ([M, N]).
  * :class:`ChunkedPhiOperator` Φ as a lazy map: re-samples walks in
                                ``chunk``-row blocks, never holds a trace.
  * :class:`KhatOperator`       K̂ = Φ_rows Φ_colsᵀ, square K̂_xx or the
                                rectangular K̂_{·x} (Eq. 12).
  * :class:`ShiftedOperator`    H = K̂ + D (D scalar σ²I or per-row noise),
                                or M K̂ M + D with a mask.

All operators are frozen dataclasses, callable (``op(v) == op.matvec(v)``),
and route every product through ``kernels.dispatch``.  ``KhatOperator``
keeps an injectable ``reduce`` hook applied to the intermediate u = Φ_colsᵀv,
for the row-sharded distributed matvec of a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..graphs.formats import Graph
from ..kernels import dispatch
from . import features
from .walks import DEFAULT_CHUNK, WalkConfig, WalkTrace


def _bcast(d, v):
    """Broadcast a scalar-or-[T] diagonal against [T] or [T, R] operands."""
    if isinstance(d, torch.Tensor) and d.dim() == 1 and v.dim() == 2:
        return d[:, None]
    return d


@dataclasses.dataclass(frozen=True)
class PhiOperator:
    """Φ ∈ R^{M×N}: the GRF feature matrix as a linear map."""

    trace: WalkTrace
    f: torch.Tensor
    n_nodes: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.trace.cols.shape[0], self.n_nodes)

    def vals(self) -> torch.Tensor:
        return features.feature_values(self.trace, self.f)

    def matvec(self, u: torch.Tensor) -> torch.Tensor:
        """y = Φ u.  u: [N(, R)] → y: [M(, R)]."""
        return dispatch.phi_matvec(self.vals(), self.trace.cols, u)

    def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
        """u = Φᵀ v.  v: [M(, R)] → u: [N(, R)]."""
        return dispatch.phi_t_matvec(self.vals(), self.trace.cols, v,
                                     self.n_nodes)

    def diag_approx(self) -> torch.Tensor:
        """diag(Φ) for square M == N (slots whose column is the own row)."""
        rows = torch.arange(self.shape[0], device=self.trace.cols.device)
        own = self.trace.cols == rows[:, None]
        vals = self.vals()
        return torch.sum(torch.where(own, vals, torch.zeros_like(vals)), dim=1)

    def diag_sq(self) -> torch.Tensor:
        """Σ_k vals² per row — K̂'s Jacobi diagonal (see khat_diag_approx)."""
        return features.khat_diag_approx(self.trace, self.f)

    def dense(self) -> torch.Tensor:
        return features.materialize_phi(self.trace, self.f, self.n_nodes)

    def take_rows(self, rows: torch.Tensor) -> "PhiOperator":
        return PhiOperator(features.take_rows(self.trace, rows), self.f,
                           self.n_nodes)

    def with_matvec_dtype(self, dtype: str) -> "PhiOperator":
        """Payload-precision variant: casting ``f`` makes the ELL payload
        (loads ⊙ f) stream in ``dtype``; every product accumulates in f32."""
        return dataclasses.replace(self, f=self.f.to(getattr(torch, dtype)))

    __call__ = matvec


@dataclasses.dataclass(frozen=True)
class ChunkedPhiOperator:
    """Φ as a *lazy* linear map over a graph: no trace is ever materialised.

    Each product re-samples walks in ``chunk``-row blocks and streams them
    through the dispatched products, so peak memory is O(chunk·K).  The
    counter RNG makes it *exactly* the Φ of ``sample_walks(graph, seed, ...)``
    with the same seed.  ``row_start``/``n_rows`` select a row range."""

    graph: Graph
    f: torch.Tensor
    seed: int
    cfg: WalkConfig
    chunk: int = DEFAULT_CHUNK
    n_rows: int | None = None
    row_start: int = 0

    @property
    def n_nodes(self) -> int:
        return self.graph.n_nodes

    @property
    def shape(self) -> tuple[int, int]:
        rows = self.n_nodes if self.n_rows is None else self.n_rows
        return (rows, self.n_nodes)

    def _kw(self):
        return dict(cfg=self.cfg, chunk=self.chunk, row_start=self.row_start,
                    n_rows=self.n_rows)

    def matvec(self, u: torch.Tensor) -> torch.Tensor:
        """y = Φ u, streamed: peak extra memory O(chunk·K)."""
        return features.phi_matvec_chunked(self.graph, self.f, u, self.seed,
                                           **self._kw())

    def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
        """u = Φᵀ v, streamed scatter-accumulate into [N(, R)]."""
        return features.phi_t_matvec_chunked(self.graph, self.f, v, self.seed,
                                             **self._kw())

    def diag_sq(self) -> torch.Tensor:
        return features.khat_diag_approx_chunked(self.graph, self.f, self.seed,
                                                 **self._kw())

    def dense(self) -> torch.Tensor:
        raise NotImplementedError(
            "ChunkedPhiOperator is lazy by design (the dense Φ is the O(N·K) "
            "materialisation it exists to avoid); for small problems sample a "
            "trace with the same seed and use PhiOperator.dense()."
        )

    def with_matvec_dtype(self, dtype: str) -> "ChunkedPhiOperator":
        return dataclasses.replace(self, f=self.f.to(getattr(torch, dtype)))

    __call__ = matvec


@dataclasses.dataclass(frozen=True)
class KhatOperator:
    """K̂ = Φ_rows Φ_colsᵀ — square (rows is cols) or cross-covariance.

    With no ``reduce`` hook and materialised traces on both sides the product
    runs the fused K̂ kernel; with a :class:`ChunkedPhiOperator` on either
    side (or a hook) it is composed as Φ_colsᵀ then Φ_rows."""

    rows: "PhiOperator | ChunkedPhiOperator"
    cols: "PhiOperator | ChunkedPhiOperator"
    reduce: Callable[[torch.Tensor], torch.Tensor] | None = None

    @property
    def n_nodes(self) -> int:
        return self.rows.n_nodes

    @property
    def shape(self) -> tuple[int, int]:
        return (self.rows.shape[0], self.cols.shape[0])

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        fusable = isinstance(self.rows, PhiOperator) and isinstance(
            self.cols, PhiOperator)
        if self.reduce is None and fusable:
            return dispatch.khat_matvec(
                self.rows.vals(), self.rows.trace.cols,
                self.cols.vals(), self.cols.trace.cols,
                v, self.n_nodes,
            )
        u = self.cols.rmatvec(v)
        if self.reduce is not None:
            u = self.reduce(u)
        return self.rows.matvec(u)

    def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
        return self.transpose().matvec(v)

    def transpose(self) -> "KhatOperator":
        return KhatOperator(self.cols, self.rows, self.reduce)

    def diag_approx(self) -> torch.Tensor:
        """Jacobi-preconditioner diagonal: Σ_k vals² of the row features."""
        return self.rows.diag_sq()

    def dense(self) -> torch.Tensor:
        return self.rows.dense() @ self.cols.dense().T

    def with_matvec_dtype(self, dtype: str) -> "KhatOperator":
        """Cast both factors' payloads; the square case keeps rows/cols as
        one shared object."""
        rows = self.rows.with_matvec_dtype(dtype)
        cols = (rows if self.cols is self.rows
                else self.cols.with_matvec_dtype(dtype))
        return KhatOperator(rows, cols, self.reduce)

    __call__ = matvec


@dataclasses.dataclass(frozen=True)
class ShiftedOperator:
    """H = K̂ + D (or M K̂ M + D when ``mask`` is given).

    ``noise`` is a scalar (σ²I) or a per-row [T] vector."""

    khat: KhatOperator
    noise: torch.Tensor | float
    mask: torch.Tensor | None = None

    @property
    def shape(self) -> tuple[int, int]:
        return self.khat.shape

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        d = _bcast(self.noise, v)
        if self.mask is None:
            return self.khat.matvec(v) + d * v
        m = _bcast(self.mask, v)
        return m * self.khat.matvec(m * v) + d * v

    rmatvec = matvec  # symmetric

    def diag_approx(self) -> torch.Tensor:
        k_diag = self.khat.diag_approx()
        if self.mask is not None:
            k_diag = k_diag * self.mask * self.mask
        return k_diag + self.noise

    def dense(self) -> torch.Tensor:
        k = self.khat.dense()
        t = k.shape[0]
        if self.mask is not None:
            k = self.mask[:, None] * k * self.mask[None, :]
        noise = torch.as_tensor(self.noise, dtype=k.dtype, device=k.device)
        return k + torch.diag(torch.broadcast_to(noise, (t,)))

    def with_matvec_dtype(self, dtype: str) -> "ShiftedOperator":
        """Only K̂'s ELL payload changes dtype; the diagonal arithmetic and
        every product output stay f32."""
        return dataclasses.replace(self, khat=self.khat.with_matvec_dtype(dtype))

    __call__ = matvec


# --- constructors ----------------------------------------------------------


def phi(trace: WalkTrace, f: torch.Tensor,
        n_nodes: int | None = None) -> PhiOperator:
    """Φ from a walk trace; ``n_nodes`` defaults to the square assumption."""
    return PhiOperator(trace, f, trace.n_nodes if n_nodes is None else n_nodes)


def khat(trace: WalkTrace, f: torch.Tensor, n_nodes: int | None = None,
         reduce: Callable | None = None) -> KhatOperator:
    """Square K̂ = ΦΦᵀ (rows == cols)."""
    p = phi(trace, f, n_nodes)
    return KhatOperator(p, p, reduce)


def khat_cross(trace_rows: WalkTrace, trace_cols: WalkTrace, f: torch.Tensor,
               n_nodes: int, reduce: Callable | None = None) -> KhatOperator:
    """Rectangular K̂[rows, cols] = Φ_rows Φ_colsᵀ (e.g. K̂_{·x}, Eq. 12)."""
    return KhatOperator(PhiOperator(trace_rows, f, n_nodes),
                        PhiOperator(trace_cols, f, n_nodes), reduce)


def shifted(trace: WalkTrace, f: torch.Tensor, noise, n_nodes: int | None = None,
            mask: torch.Tensor | None = None,
            reduce: Callable | None = None) -> ShiftedOperator:
    """H = K̂ + D from a walk trace — the GP solve operator in one call."""
    return ShiftedOperator(khat(trace, f, n_nodes, reduce), noise, mask)


def chunked_phi(graph: Graph, f: torch.Tensor, seed: int, cfg: WalkConfig,
                chunk: int = DEFAULT_CHUNK, n_rows: int | None = None,
                row_start: int = 0) -> ChunkedPhiOperator:
    """Lazy Φ over ``graph``; same rows as ``sample_walks(graph, seed, ...)``."""
    return ChunkedPhiOperator(graph, f, seed, cfg, chunk, n_rows, row_start)


def chunked_khat(graph: Graph, f: torch.Tensor, seed: int, cfg: WalkConfig,
                 chunk: int = DEFAULT_CHUNK,
                 reduce: Callable | None = None) -> KhatOperator:
    """Square K̂ = ΦΦᵀ with both factors lazy/chunked (peak O(chunk·K))."""
    p = chunked_phi(graph, f, seed, cfg, chunk)
    return KhatOperator(p, p, reduce)


def chunked_khat_cross(graph: Graph, trace_cols: WalkTrace, f: torch.Tensor,
                       seed: int, cfg: WalkConfig, chunk: int = DEFAULT_CHUNK,
                       reduce: Callable | None = None) -> KhatOperator:
    """K̂[·, cols] = Φ_full Φ_colsᵀ with the full-graph factor lazy (Eq. 12).

    ``trace_cols`` is the small materialised trace (e.g. training nodes,
    sampled with the *same seed* so its rows agree with the lazy Φ)."""
    return KhatOperator(chunked_phi(graph, f, seed, cfg, chunk),
                        PhiOperator(trace_cols, f, graph.n_nodes), reduce)
