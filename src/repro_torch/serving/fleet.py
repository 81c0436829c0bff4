"""Overlapped, double-buffered GP serving fleet (port of
``repro/serving/fleet.py``).

``GPServeLoop`` (engine.py) is synchronous: every wave waits for the
device before the host packs the next one, and every ``observe`` pays the
eager wrapper's host reads of ``count`` and the flags.  :class:`GPFleetLoop`
is the overlapped front end:

  * **Double-buffered waves** — wave k is dispatched without waiting: its
    mean, variance and draw are copied into a pinned host buffer with a
    non-blocking copy and a CUDA event is recorded behind it.  The wave is
    reaped at the *start* of step k+1, which waits on that event, so the
    host admits and packs wave k+1 (and the caller submits traffic) while
    wave k runs on the card.
  * **Coalesced, donated mutations** — queued observes are batched into
    ONE ``observe_batch_async`` call per step (no host read) and runs of
    forgets into one ``forget_batch_async``, with the mutable state
    tensors written in place (``donate=True``, update.py).  The fleet
    keeps a host-side upper bound on the live count (read at construction
    and at each flag check; +n per append, −1 per forget), so a forget
    sweeps its downdate only as far as the sync path's does.
  * **Health flags, read lazily** — overflow / rejected / needs_refit are
    read every ``flag_check_every`` steps (and at drain); a pending
    ``needs_refit`` is answered with the O(m³) refit fallback, as the sync
    wrapper does, only a few waves later (the jitter-clamped factor stays
    SPD meanwhile).
  * **WAL before dispatch** — with a ``journal``, every mutation is
    journalled (flushed, write-ahead) *before* it is dispatched, and a
    ``kill_point`` sits between the two: a crash loses at most an un-acked
    op, never an acked one.

**Pipeline invariant.**  :meth:`step` reaps wave k-1 *before* it applies
queued mutations and dispatches wave k.  On one CUDA stream a later
in-place write could not overtake an earlier wave's reads anyway; the
order keeps FIFO semantics across op kinds and mirrors the JAX package,
whose donation needs it.

The marginal draws' normals come from a ``torch.Generator`` on the state's
device, drawn in wave order, so a fleet and a ``GPServeLoop`` with
generators in the same state draw the same normals wave for wave.  Works
over a single :class:`ServeState` or a :class:`ShardedServeState`
(mutations run once on rank 0 and are broadcast; waves run on every rank).

Observability: the ``serving.fleet.observe`` / ``.forget`` /
``.dispatch`` / ``.reap`` spans (dispatch times the enqueue only), the
``serving.fleet.observes`` and ``serving.fleet.submit.rejects`` counters,
the ``serving.fleet.queue_depth`` and (sharded) ``serving.fleet.shard_depth``
gauges and the ``serving.fleet.wave_latency`` histogram, dispatch to reap.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from .. import obs
from ..resilience import faults
from . import update
from .engine import GPRequest, _engine_step
from .sharded import ShardedServeState, _sharded_engine_step
from .state import ServeState


@dataclasses.dataclass
class _Wave:
    """An in-flight wave: the slot snapshot and its un-reaped answers."""

    slots: list
    out: torch.Tensor            # [3, batch]: mean, var, draw
    done: torch.cuda.Event | None
    t0: float
    served: int


class GPFleetLoop:
    """Overlapped GP serving over one state or a sharded one.

    :meth:`submit` / :meth:`submit_observe` / :meth:`submit_forget` enqueue
    ops FIFO with bounded backpressure (``max_pending`` ops; None =
    unbounded): a full queue refuses at admission
    (``serving.fleet.submit.rejects``) and never drops work in flight.
    :meth:`step` advances the pipeline one wave; :meth:`drain` runs it dry.

    Overflow behaves like ``on_overflow="reject"`` (the masked drop):
    excess appends bump the ``overflow`` flag and the caller sheds load.
    With ``donate=True`` (the default) the fleet writes its state's tensors
    in place; it copies the mutable tensors of the state it is given first,
    so those writes never reach the caller's state (a sharded state holds
    copies of its own already).
    """

    def __init__(self, state: ServeState | ShardedServeState, batch: int,
                 generator: torch.Generator | None = None,
                 max_pending: int | None = None,
                 journal=None,
                 donate: bool = True,
                 auto_refit: bool = True,
                 flag_check_every: int = 8):
        self.sharded = isinstance(state, ShardedServeState)
        if self.sharded and batch % state.n_shards:
            raise ValueError(f"batch {batch} must divide evenly across "
                             f"{state.n_shards} shards")
        if donate and not self.sharded:
            state = update.copy_mutable(state)
        self.state = state
        self.batch = batch
        dev = self.serve_state.device
        self.generator = (generator if generator is not None else
                          torch.Generator(device=dev).manual_seed(0))
        self.max_pending = max_pending
        self.journal = journal
        self.donate = donate
        self.auto_refit = auto_refit
        self.flag_check_every = flag_check_every
        self.slots: list[tuple[GPRequest, int] | None] = [None] * batch
        self.slot_nodes = np.zeros(batch, dtype=np.int32)
        self.pending: collections.deque = collections.deque()
        self._inflight: _Wave | None = None
        self._flags = (0, 0)        # last-seen (overflow, rejected)
        # An upper bound on the live count, kept on the host without a read
        # after this one: a forget sweeps its downdate only this far.
        self._live_bound = int(self.serve_state.count)
        self._steps = 0
        self.served = 0

    # -- canonical state access ----------------------------------------------
    @property
    def serve_state(self) -> ServeState:
        """The canonical ServeState (this rank's copy when sharded)."""
        return self.state.state if self.sharded else self.state

    # -- submission (bounded, FIFO across op kinds) --------------------------
    def _submit(self, op) -> bool:
        if (self.max_pending is not None
                and len(self.pending) >= self.max_pending):
            obs.inc("serving.fleet.submit.rejects")
            return False
        self.pending.append(op)
        obs.gauge("serving.fleet.queue_depth", len(self.pending))
        return True

    def submit(self, req: GPRequest) -> bool:
        """Enqueue a query request with backpressure (False = queue full)."""
        return self._submit(("query", req))

    def submit_observe(self, nodes, ys) -> bool:
        """Enqueue observation append(s), coalesced into one
        ``observe_batch_async`` with any adjacent queued observes."""
        return self._submit((
            "observe",
            np.asarray(nodes, np.int32).reshape(-1),
            np.asarray(ys, np.float32).reshape(-1),
        ))

    def submit_forget(self, slot: int) -> bool:
        """Enqueue a forget (rank-1 downdate) of buffer ``slot``."""
        return self._submit(("forget", int(slot)))

    # -- mutations (WAL → kill point → async dispatch) -----------------------
    def _apply_observe(self, nodes: np.ndarray, ys: np.ndarray) -> None:
        if self.journal is not None:
            # Write-ahead: durable BEFORE the mutation is dispatched.
            self.journal.log(
                "observe", nodes=[int(v) for v in nodes],
                ys=[float(v) for v in ys],
                on_overflow="reject", auto_refit=self.auto_refit,
            )
        faults.kill_point("serving.fleet.observe")
        with obs.span("serving.fleet.observe", n=int(len(nodes))):
            if self.sharded:
                self.state.observe_batch(nodes, ys, sync=False)
            else:
                self.state = update.observe_batch_async(
                    self.state, nodes, ys, donate=self.donate)
        self._live_bound = min(self._live_bound + len(nodes),
                               self.serve_state.capacity)
        obs.inc("serving.fleet.observes", int(len(nodes)))

    def _apply_forget(self, slots: list[int]) -> None:
        if self.journal is not None:
            # One record per slot: replay folds single-slot forgets, and
            # forget_batch is defined as exactly that sequential fold.
            for slot in slots:
                self.journal.log("forget", slot=int(slot))
        faults.kill_point("serving.fleet.forget")
        with obs.span("serving.fleet.forget", n=len(slots)):
            if self.sharded:
                self.state.forget_batch(slots, sync=False)
            else:
                self.state = update.forget_batch_async(
                    self.state, slots, donate=self.donate,
                    live_bound=self._live_bound)
        self._live_bound = max(self._live_bound - len(slots), 0)

    def _process_mutations(self) -> None:
        """Apply every mutation at the queue head, coalescing runs of
        observes (and runs of forgets) into one call each.  Stops at the
        first query, so FIFO order across op kinds holds."""
        while self.pending and self.pending[0][0] != "query":
            if self.pending[0][0] == "observe":
                nodes, ys = [], []
                while self.pending and self.pending[0][0] == "observe":
                    _, n, yv = self.pending.popleft()
                    nodes.append(n)
                    ys.append(yv)
                self._apply_observe(np.concatenate(nodes), np.concatenate(ys))
            else:
                slots = []
                while self.pending and self.pending[0][0] == "forget":
                    slots.append(self.pending.popleft()[1])
                self._apply_forget(slots)

    # -- admission -----------------------------------------------------------
    def _admit(self, req: GPRequest) -> bool:
        while req.admitted < len(req.nodes):
            try:
                slot = self.slots.index(None)
            except ValueError:
                obs.inc("serving.admit.rejects")
                return False
            self.slots[slot] = (req, req.admitted)
            self.slot_nodes[slot] = req.nodes[req.admitted]
            req.admitted += 1
            obs.inc("serving.admit.accepts")
        return True

    def _admit_pending(self) -> None:
        while self.pending and self.pending[0][0] == "query":
            if not self._admit(self.pending[0][1]):
                break
            self.pending.popleft()
        obs.gauge("serving.fleet.queue_depth", len(self.pending))

    # -- the pipeline --------------------------------------------------------
    def _dispatch(self) -> None:
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if not live:
            return
        dev = self.serve_state.device
        # The span times the enqueue only; serving.fleet.wave_latency is
        # the device-honest wave time, dispatch to reap.
        with obs.span("serving.fleet.dispatch", fill=len(live) / self.batch,
                      served=len(live)):
            nodes = update._to_device_async(self.slot_nodes, torch.int32, dev)
            if self.sharded:
                mean, var, draw = _sharded_engine_step(self.state, nodes,
                                                       self.generator)
            else:
                mean, var, draw = _engine_step(self.state, nodes,
                                               self.generator)
            out, done = torch.stack([mean, var, draw]), None
            if dev.type == "cuda":
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                out = host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
        self._inflight = _Wave(slots=list(self.slots), out=out, done=done,
                               t0=time.perf_counter(), served=len(live))
        # Free the slots at once: the device holds the node ids by value,
        # so wave k+1's admission proceeds while wave k runs.
        self.slots = [None] * self.batch
        if self.sharded:
            for shard in range(self.state.n_shards):
                obs.gauge("serving.fleet.shard_depth", len(live),
                          labels={"shard": shard})

    def _reap(self) -> int:
        w, self._inflight = self._inflight, None
        if w is None:
            return 0
        with obs.span("serving.fleet.reap", served=w.served):
            if w.done is not None:
                w.done.synchronize()
            mean, var, draw = w.out.numpy()
        obs.observe("serving.fleet.wave_latency", time.perf_counter() - w.t0)
        for i, entry in enumerate(w.slots):
            if entry is None:
                continue
            req, pos = entry
            req.mean[pos] = mean[i]
            req.var[pos] = var[i]
            req.draw[pos] = draw[i]
            req.answered += 1
            if req.answered == len(req.nodes):
                req.done = True
        obs.inc("serving.queries_served", w.served)
        self.served += w.served
        return w.served

    def _check_flags(self) -> None:
        """Read the health flags (waits for the mutation chain — called
        where the pipeline is cheap to sync) and run the refit fallback if
        the factor has been running on jitter."""
        st = self.serve_state
        ov, rej, nrf, self._live_bound = (int(v) for v in torch.stack(
            [st.overflow, st.rejected, st.needs_refit, st.count]).tolist())
        if ov > self._flags[0]:
            obs.inc("serving.observe.overflow", ov - self._flags[0])
        if rej > self._flags[1]:
            obs.inc("serving.observe.rejected", rej - self._flags[1])
        self._flags = (ov, rej)
        if self.auto_refit and nrf > 0:
            obs.inc("serving.refit.fallback")
            if self.journal is not None:
                self.journal.log("refit")
            faults.kill_point("serving.fleet.refit")
            if self.sharded:
                self.state.refit()
            else:
                self.state = update.refit(self.state)

    def step(self) -> int:
        """Advance the pipeline one wave; returns #queries answered.

        The order is fixed: reap wave k-1 first, then dispatch queued
        mutations (WAL first), admit queries into the freed slots, and
        dispatch wave k, which runs on the card while the caller does host
        work."""
        served = self._reap()
        self._process_mutations()
        self._admit_pending()
        self._dispatch()
        self._steps += 1
        if self.flag_check_every and self._steps % self.flag_check_every == 0:
            self._check_flags()
        return served

    def drain(self, progress=None) -> int:
        """Run :meth:`step` until the queue, the slots and the pipeline are
        empty, then check the flags.  Returns #queries answered."""
        served = 0
        while (self.pending or self._inflight is not None
               or any(s is not None for s in self.slots)):
            n = self.step()
            served += n
            if progress:
                progress(n, len(self.pending))
        self._check_flags()
        return served

    def run(self, requests: list[GPRequest], progress=None):
        """Enqueue ``requests`` (an explicit batch bypasses backpressure,
        like ``GPServeLoop.run``) and drain the pipeline."""
        for req in requests:
            self.pending.append(("query", req))
        self.drain(progress)
        return requests
