"""Online GP serving state: cached train features + incremental Cholesky
(port of ``repro/serving/state.py``).

Because GRFs give an explicit feature map K̂ = ΦΦᵀ, the train-block system
the posterior needs is the *m×m* matrix A = K̂_xx + σ²I (m = observations
≪ N).  :class:`ServeState` caches everything a query needs, in
static-capacity buffers:

  * ``trace`` — the observed nodes' feature rows Φ_x in ELL layout
    ([capacity, K]; dead rows carry zero loads, so they vanish from every
    Gram product),
  * ``chol``  — the lower Cholesky L of A ([capacity, capacity]; the dead
    block is the identity, so full-size triangular solves are exact),
  * ``alpha`` — the representer weights A⁻¹ y.

A batched query for q nodes costs one cross-Gram K̂_{q,x} (the
``gram_block`` kernel) plus a q-column triangular solve — no CG and nothing
N-scale; N enters only through the lazy walk sampling of the q query rows.

``count`` and the health flags are 0-d int32 tensors on the state's device,
as in the JAX package, so appends run without reading anything back to the
host; ``seed`` is the uint32 walk seed (a Python int), the identity of Φ.
The ``serving.var_clamped`` obs tap counts clamped variances when obs is
enabled.  Not in this slice: the fault-injection sites the JAX serving code
threads through.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import obs
from ..core import features
from ..core.walks import WalkConfig, WalkTrace
from ..graphs.formats import Graph
from ..kernels import dispatch


@dataclasses.dataclass(frozen=True)
class ServeState:
    """Online-GP posterior over a fixed graph.

    Attributes:
      graph: the serving graph (walk substrate for lazy query rows).
      nodes: int32[capacity] observed node ids (0 beyond ``count``).
      y:     float32[capacity] observed targets (0 beyond ``count``).
      count: int32 0-d tensor — live observations m.
      trace: ELL feature rows of the observed nodes ([capacity, K]; rows at
             or beyond ``count`` have zero loads).
      chol:  float32[capacity, capacity] lower Cholesky of K̂_xx + σ²I on the
             live block, identity on the dead block.
      alpha: float32[capacity] representer weights (K̂_xx + σ²I)⁻¹ y.
      f:     modulation vector (kernel hyperparameters).
      sigma_n2: observation-noise variance σ² (0-d float32 tensor).
      seed:  uint32 walk seed — query rows sampled with it are rows of the
             *same* feature matrix as the cached train rows.
      overflow: int32 0-d — appends dropped because the state was full.
      rejected: int32 0-d — appends refused for a non-finite payload,
             target or Schur complement.
      needs_refit: int32 0-d — appends whose Schur complement was near zero
             and got jitter-clamped since the last refactorisation.
      cfg:   WalkConfig.
    """

    graph: Graph
    nodes: torch.Tensor
    y: torch.Tensor
    count: torch.Tensor
    trace: WalkTrace
    chol: torch.Tensor
    alpha: torch.Tensor
    f: torch.Tensor
    sigma_n2: torch.Tensor
    seed: int
    overflow: torch.Tensor
    rejected: torch.Tensor
    needs_refit: torch.Tensor
    cfg: WalkConfig

    @property
    def capacity(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.graph.n_nodes

    @property
    def device(self) -> torch.device:
        return self.chol.device

    def live_mask(self) -> torch.Tensor:
        """float32[capacity]: 1 for live observation slots, 0 for dead."""
        idx = torch.arange(self.capacity, device=self.device)
        return (idx < self.count).to(torch.float32)

    def vals(self) -> torch.Tensor:
        """Cached train feature values [capacity, K] (zero on dead rows)."""
        return features.feature_values(self.trace, self.f)


def _i32(x: int, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int32, device=dev)


def init_state(
    graph: Graph,
    seed: int,
    f: torch.Tensor,
    sigma_n2,
    capacity: int,
    cfg: WalkConfig,
) -> ServeState:
    """Empty state on the graph's device: identity Cholesky, zero-load rows,
    zero observations.  ``seed`` is the uint32 walk seed."""
    dev = graph.device
    k = cfg.slots
    return ServeState(
        graph=graph,
        nodes=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        y=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        count=_i32(0, dev),
        trace=WalkTrace(
            cols=torch.zeros((capacity, k), dtype=torch.int32, device=dev),
            loads=torch.zeros((capacity, k), dtype=torch.float32, device=dev),
            lens=torch.zeros((capacity, k), dtype=torch.int32, device=dev),
        ),
        chol=torch.eye(capacity, dtype=torch.float32, device=dev),
        alpha=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        f=torch.as_tensor(f, dtype=torch.float32).to(dev),
        sigma_n2=torch.as_tensor(sigma_n2, dtype=torch.float32).to(dev),
        seed=int(seed),
        overflow=_i32(0, dev),
        rejected=_i32(0, dev),
        needs_refit=_i32(0, dev),
        cfg=cfg,
    )


def query_rows(state: ServeState, query_nodes: torch.Tensor) -> WalkTrace:
    """Lazily sample the Φ rows for ``query_nodes`` (subset mode).

    The counter RNG keyed on absolute node ids makes these rows *exactly*
    the rows of the Φ the train block was built from."""
    g = state.graph
    cols, loads, lens = dispatch.walk_sample(
        g.neighbors, g.weights, g.deg,
        torch.as_tensor(query_nodes).to(device=g.device, dtype=torch.int32),
        state.seed, n_walkers=state.cfg.n_walkers, p_halt=state.cfg.p_halt,
        l_max=state.cfg.l_max, reweight=state.cfg.reweight,
        scheme=state.cfg.scheme,
    )
    return WalkTrace(cols=cols, loads=loads, lens=lens)


def solve_lower(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L⁻¹ b for a [c] or [c, q] right-hand side."""
    if b.dim() == 1:
        return solve_lower(chol, b[:, None])[:, 0]
    return torch.linalg.solve_triangular(chol, b, upper=False)


def solve_chol(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = (L Lᵀ)⁻¹ b via two triangular solves (the no-CG serving solve)."""
    if b.dim() == 1:
        return solve_chol(chol, b[:, None])[:, 0]
    z = torch.linalg.solve_triangular(chol, b, upper=False)
    return torch.linalg.solve_triangular(chol.T, z, upper=True)


def posterior_moments(state: ServeState, query_nodes):
    """Exact closed-form predictive mean/variance (paper Eq. 3/4).

        μ(q) = K̂_{q,x} α,          α = (K̂_xx + σ²I)⁻¹ y
        σ²(q) = K̂(q,q) − ‖L⁻¹ K̂_{x,q}‖²

    from the cached Cholesky — O(q·m²), nothing N-scale.
    Returns (mean[q], var[q])."""
    return _moments_impl(state, query_nodes)


def _query_features(state: ServeState, query_nodes):
    """Lazy Φ rows + feature values for ``query_nodes``."""
    trace_q = query_rows(state, query_nodes)
    return trace_q, features.feature_values(trace_q, state.f)


def _mean_whiten(state: ServeState, k_qx: torch.Tensor):
    """mean[q] and the whitened cross-block v = L⁻¹ K̂_{x,q} [c, q]."""
    mean = k_qx @ state.alpha
    v = solve_lower(state.chol, k_qx.T.contiguous())
    return mean, v


def _cross_solve(state: ServeState, query_nodes):
    """The shared query core: lazy rows, cross-Gram, mean, whitened solve.

    Returns (trace_q, vals_q, mean[q], v) with v = L⁻¹ K̂_{x,q} [c, q] —
    everything the marginal moments and the joint Thompson draw need."""
    trace_q, vals_q = _query_features(state, query_nodes)
    k_qx = dispatch.gram_block(
        vals_q, trace_q.cols, state.vals(), state.trace.cols
    )  # [q, capacity]; dead train rows contribute exact zeros
    mean, v = _mean_whiten(state, k_qx)
    return trace_q, vals_q, mean, v


def _moments_tail(state: ServeState, trace_q: WalkTrace, mean, v):
    """Marginal variance from the whitened cross-block.  K̂ is PSD, so a
    negative variance is float32 cancellation: clamped to zero, and the
    clamps counted by the ``serving.var_clamped`` tap (when obs is on)."""
    k_qq = features.khat_diag_exact(trace_q, state.f)
    var_raw = k_qq - torch.sum(v * v, dim=0)
    if obs.enabled():
        obs.tap("serving.var_clamped", torch.sum(var_raw < 0),
                     kind="counter")
    return mean, torch.clamp(var_raw, min=0.0)


def _moments_impl(state: ServeState, query_nodes):
    trace_q, _, mean, v = _cross_solve(state, query_nodes)
    return _moments_tail(state, trace_q, mean, v)
