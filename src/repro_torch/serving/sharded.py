"""Sharded GP serving state: the cached train rows split over the ranks of
a serving mesh (port of ``repro/serving/sharded.py``).

A wave is O(q·K²·m + q·m²), and the only term that grows with the
capacity m is the cross-Gram K̂_{q,x} — q query rows against the m cached
train rows — which is row-parallel over the *train* side.  So:

  * ``trace`` (the cached ELL rows, [capacity, K]) is split by rows: rank r
    reads rows [r·capacity/P, (r+1)·capacity/P);
  * ``chol``, ``alpha``, ``y``, ``nodes``, the scalars and the graph are
    whole on every rank (the m×m solves are tiny, and the whole factor lets
    every rank answer the whitened solve itself).

A sharded query pads its nodes to a multiple of P with node 0, each rank
lazily samples its slice of the query rows (the counter RNG keyed on
absolute node ids makes subset sampling exact), the ranks ``all_gather``
the q query rows, each computes its *local* cross-Gram block against its
train rows (``gram_block``, [q, capacity/P]), places it at its offset in a
zero [q, capacity] block, and one ``all_reduce`` sums the blocks.  Adding
zeros is exact, and everything downstream (mean, whitened solve, variance,
joint draw) is the single-device code on the whole factor.  The card's
``gram_block`` computes each entry in an order of its own rows and columns,
so the sum equals the single-device cross-Gram bit for bit there; the plain
version's ``einsum`` may sum an entry in another order when the column
block is narrower (the CPU's matmul picks its blocking by shape), and then
the answers agree to float32 rounding.

**Replication invariant.**  Every mutation (observe / forget / refit /
ingest / refit_alpha) runs ONCE, on rank 0's canonical
:class:`ServeState`, through the guarded update layer; then
``torch.distributed.broadcast`` sends the mutable leaves (and f and σ²,
which a refit may change) from rank 0 into every other rank's copy, and
each rank re-slices its trace rows.  Ranks never mutate on their own, so
they cannot diverge, even where atomics sum in a run-dependent order.
Every rank must make each call together, as a collective; an exception
raised on rank 0 leaves the others waiting in the broadcast until the
group's timeout.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..core import features
from ..core.walks import WalkTrace
from ..kernels import dispatch
from ..launch.mesh import make_serving_mesh
from ..resilience import faults
from . import update
from .engine import _joint_draw_tail, _normals
from .state import ServeState, _mean_whiten, _moments_tail, query_rows


def _gather(local: torch.Tensor, mesh) -> torch.Tensor:
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local.contiguous(), group=mesh.group)
    return torch.cat(parts)


def _sharded_cross(state: ServeState, qnodes: torch.Tensor, mesh):
    """The all-reduced cross-Gram K̂_{q,x} [q, capacity] and the gathered
    query rows, on every rank (q a multiple of the mesh size)."""
    trace_ql = faults.guard_trace(query_rows(state, qnodes[mesh.rows(
        qnodes.shape[0])]))
    trace_q = WalkTrace(cols=_gather(trace_ql.cols, mesh),
                        loads=_gather(trace_ql.loads, mesh),
                        lens=_gather(trace_ql.lens, mesh))
    vals_q = features.feature_values(trace_q, state.f)
    local = _local_trace(state, mesh)
    k_local = dispatch.gram_block(
        vals_q, trace_q.cols, features.feature_values(local, state.f),
        local.cols)                     # [q, capacity/P]: this rank's rows
    k_full = torch.zeros((qnodes.shape[0], state.capacity),
                         dtype=k_local.dtype, device=k_local.device)
    k_full[:, mesh.rows(state.capacity)] = k_local
    dist.all_reduce(k_full, op=dist.ReduceOp.SUM, group=mesh.group)
    return k_full, trace_q, vals_q


def _local_trace(state: ServeState, mesh) -> WalkTrace:
    rows = mesh.rows(state.capacity)
    tr = state.trace
    return WalkTrace(tr.cols[rows], tr.loads[rows], tr.lens[rows])


def _sharded_moments(state, qnodes, mesh):
    k_qx, trace_q, _ = _sharded_cross(state, qnodes, mesh)
    mean, v = _mean_whiten(state, k_qx)
    return _moments_tail(state, trace_q, mean, v)


def _sharded_engine_step(sharded: "ShardedServeState", slot_nodes: torch.Tensor,
                         generator: torch.Generator):
    """Sharded twin of ``engine._engine_step``: the same draw discipline, so
    a wave's marginal draws equal the single-device engine's."""
    mean, var = _sharded_moments(sharded.state, slot_nodes, sharded.mesh)
    eps = _normals(generator, mean.shape, mean.device)
    return mean, var, mean + torch.sqrt(var) * eps


class ShardedServeState:
    """A :class:`ServeState` spread over a 1-D serving mesh.

    Holds this rank's copy of the canonical state (``.state``: the source of
    truth, mutated on rank 0 only and broadcast); the query path reads its
    trace in this rank's block of rows, ``mesh.rows(capacity)``.
    ``capacity`` must divide evenly by the mesh size; query batches are
    padded to a multiple of it with node 0 (marginal moments are row-wise,
    so padding never changes real answers).  The constructor copies the
    state's mutable tensors, so the broadcasts never write into the
    caller's."""

    def __init__(self, state: ServeState, mesh=None,
                 n_shards: int | None = None):
        if mesh is None:
            if n_shards and state.capacity % n_shards:
                raise ValueError(f"capacity {state.capacity} must divide "
                                 f"evenly across {n_shards} shards")
            mesh = make_serving_mesh(n_shards)
            if mesh is None:
                raise ValueError(f"rank {dist.get_rank()} is outside the "
                                 f"{n_shards}-shard serving mesh")
        if len(mesh.axis_names) != 1:
            raise ValueError(f"serving mesh must be 1-D, got axes {mesh.axis_names}")
        if state.capacity % mesh.size:
            raise ValueError(f"capacity {state.capacity} must divide evenly "
                             f"across {mesh.size} shards")
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.state = _contiguous(state, copy=True)

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @property
    def capacity(self) -> int:
        return self.state.capacity

    def _pad(self, nodes):
        nodes = update._as_tensor(nodes, torch.int32, self.state.device)
        q = nodes.shape[0]
        pad = (-q) % self.n_shards
        if pad:
            nodes = torch.cat([nodes, nodes.new_zeros(pad)])
        return nodes, q

    # -- queries (sharded) ---------------------------------------------------
    def posterior_moments(self, query_nodes):
        """Exact closed-form (mean, var) — the single-device
        ``posterior_moments`` (see the module docstring for when bit for
        bit)."""
        qnodes, q = self._pad(query_nodes)
        mean, var = _sharded_moments(self.state, qnodes, self.mesh)
        return mean[:q], var[:q]

    def thompson_draw(self, nodes, generator: torch.Generator,
                      n_samples: int = 1):
        """Exact joint posterior samples [q, n_samples].  Equals the
        single-device ``thompson_draw`` from a generator in the same state
        when q is a multiple of the shard count; node-0 padding otherwise
        changes the normals' layout (the same distribution, not the same
        draw)."""
        qnodes, q = self._pad(nodes)
        k_qx, trace_q, vals_q = _sharded_cross(self.state, qnodes, self.mesh)
        mean, v = _mean_whiten(self.state, k_qx)
        eps = _normals(generator, (qnodes.shape[0], n_samples), mean.device)
        return _joint_draw_tail(trace_q, vals_q, mean, v, eps)[:q]

    # -- mutations (once on rank 0, then broadcast) --------------------------
    def _mutate(self, fn) -> None:
        if self.mesh.rank == 0:
            # A broadcast moves raw memory: the leaves must be row-major on
            # every rank (a Cholesky factor comes back column-major).
            self.state = _contiguous(fn(self.state))
        st = self.state
        leaves = [x for x in update._pack(st) if isinstance(x, torch.Tensor)]
        leaves += [st.trace.cols, st.trace.loads, st.trace.lens, st.f,
                   st.sigma_n2]
        for t in leaves:
            # Group rank 0 is global rank 0: a serving mesh is the first
            # ranks of the default group.
            dist.broadcast(t, src=0, group=self.mesh.group)

    def observe(self, node, y, **kwargs) -> None:
        self._mutate(lambda st: update.observe(st, node, y, **kwargs))

    def observe_batch(self, nodes, ys, *, sync: bool = True, **kwargs) -> None:
        """Guarded batched append.  ``sync=False`` takes the no-sync donated
        path (``observe_batch_async``) — the fleet's — whose health flags
        the caller reads at its next blocking point."""
        if sync:
            self._mutate(lambda st: update.observe_batch(st, nodes, ys, **kwargs))
        else:
            self._mutate(lambda st: update.observe_batch_async(st, nodes, ys))

    def forget(self, slot) -> None:
        self._mutate(lambda st: update.forget(st, slot))

    def forget_batch(self, slots, *, sync: bool = True) -> None:
        if sync:
            self._mutate(lambda st: update.forget_batch(st, slots))
        else:
            self._mutate(lambda st: update.forget_batch_async(st, slots))

    def ingest(self, nodes, ys) -> None:
        self._mutate(lambda st: update.ingest(st, nodes, ys))

    def refit(self, **kwargs) -> None:
        self._mutate(lambda st: update.refit(st, **kwargs))

    def refit_alpha(self, **kwargs) -> None:
        def fn(st):
            res = update.refit_alpha(st, **kwargs)
            return res[0] if isinstance(res, tuple) else res
        self._mutate(fn)


def _contiguous(state: ServeState, copy: bool = False) -> ServeState:
    """``state`` with its broadcast leaves row-major (copied when ``copy``,
    so that no broadcast writes into the caller's tensors)."""
    def own(x):
        return (x.clone(memory_format=torch.contiguous_format) if copy
                else x.contiguous())

    packed = [WalkTrace(own(x.cols), own(x.loads), own(x.lens))
              if isinstance(x, WalkTrace) else own(x)
              for x in update._pack(state)]
    return dataclasses.replace(update._unpack(state, packed), f=own(state.f),
                               sigma_n2=own(state.sigma_n2))
