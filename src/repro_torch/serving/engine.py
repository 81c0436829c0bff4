"""Micro-batching GP query engine (port of ``repro/serving/engine.py``).

Fixed-capacity request slots, admission, one batched step per wave: each
wave lazily samples Φ rows for the slot nodes, takes one cross-Gram block
against the cached train rows (the ``gram_block`` kernel) and answers
mean / variance / Thompson-draw requests from the cached Cholesky.  No CG
anywhere; a wave is O(q·K²·m + q·m²) whatever N is.

Request node ids are admitted *individually* into slots, so a 1000-node
request spans several waves of a batch-64 engine.

:func:`thompson_draw` is the batch-BO entry point: an exact *joint* MVN
draw over a candidate set.  Random normals come from an explicit
``torch.Generator`` (drawn on its device); :func:`_joint_draw_tail` takes
them as an argument so that a test can feed it the JAX package's draw.

Observability (when ``obs`` is enabled): admission and backpressure
counters, the ``serving.queue_depth`` gauge, a ``serving.wave`` span per
wave (its copy to the host inside the window), ``serving.queries_served``
and the ``serving.wave.fill`` histogram, a ``serving.thompson_draw`` span,
and the ``serving.thompson.cov_fallback`` tap.  Fault injection needs no
site here: every wave and draw reaches ``state._query_features``, whose
hooks read the active fault plan at the call (the JAX package passes it
into its traces as a static argument instead).
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from .. import obs
from ..kernels import dispatch
from .state import ServeState, _cross_solve, _moments_impl
from .update import _as_tensor, cholesky_checked


@dataclasses.dataclass
class GPRequest:
    """A batch of posterior queries for ``nodes`` (filled in admission order).

    ``draw`` holds one Thompson sample per node from the *marginal*
    posterior (a wave mixes nodes of different requests, so joint draws
    across a wave mean nothing — use :func:`thompson_draw` for those)."""

    nodes: np.ndarray
    mean: np.ndarray = None
    var: np.ndarray = None
    draw: np.ndarray = None
    admitted: int = 0
    answered: int = 0
    done: bool = False

    def __post_init__(self):
        self.nodes = np.asarray(self.nodes, dtype=np.int32).reshape(-1)
        n = len(self.nodes)
        self.mean = np.zeros(n, np.float32)
        self.var = np.zeros(n, np.float32)
        self.draw = np.zeros(n, np.float32)
        if n == 0:  # nothing to answer — never reaches a slot
            self.done = True


def _normals(generator: torch.Generator, shape, device) -> torch.Tensor:
    gdev = generator.device
    return torch.randn(shape, generator=generator, device=gdev,
                       dtype=torch.float32).to(device)


def _engine_step(state: ServeState, slot_nodes: torch.Tensor,
                 generator: torch.Generator):
    # var is clamped to >= 0 inside _moments_impl, so the marginal draw's
    # sqrt never makes NaN.
    mean, var = _moments_impl(state, slot_nodes)
    eps = _normals(generator, mean.shape, mean.device)
    return mean, var, mean + torch.sqrt(var) * eps


class GPServeLoop:
    """Fixed-batch GP serving: admit up to ``batch`` concurrent node queries.

    Dead slots are padded with node 0 and answered-then-discarded, so every
    wave has the same shape.  Partially-admitted requests queue in
    ``pending`` (bounded by ``max_pending`` requests; None = unbounded):
    :meth:`submit` enqueues with backpressure and :meth:`drain` runs the
    admit/step loop.  The marginal draws' normals come from ``generator``,
    by default one on the state's device, so a wave draws them there."""

    def __init__(self, state: ServeState, batch: int,
                 generator: torch.Generator | None = None,
                 max_pending: int | None = None):
        self.state = state
        self.batch = batch
        self.generator = (generator if generator is not None else
                          torch.Generator(device=state.device).manual_seed(0))
        self.slots: list[tuple[GPRequest, int] | None] = [None] * batch
        self.slot_nodes = np.zeros(batch, dtype=np.int32)
        self.max_pending = max_pending
        self.pending: collections.deque[GPRequest] = collections.deque()

    # -- admission -----------------------------------------------------------
    def admit(self, req: GPRequest) -> bool:
        """Place pending node ids of ``req`` into free slots.

        Returns True once the request is fully admitted (its answers arrive
        over the next wave(s)); False while slots ran out."""
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

    def submit(self, req: GPRequest) -> bool:
        """Enqueue a request for :meth:`drain` with backpressure: False when
        the bounded pending queue is full (the caller backs off)."""
        if (self.max_pending is not None
                and len(self.pending) >= self.max_pending):
            obs.inc("serving.submit.rejects")
            return False
        self.pending.append(req)
        obs.gauge("serving.queue_depth", len(self.pending))
        return True

    # -- batched query step --------------------------------------------------
    def step(self) -> int:
        """Answer every occupied slot in one wave; returns #served."""
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if not live:
            return 0
        fill = len(live) / self.batch
        # The copy to the host waits for the wave, so the span times
        # dispatch + execution without an extra synchronisation.
        with obs.span("serving.wave", fill=fill, served=len(live)):
            nodes = torch.from_numpy(self.slot_nodes).to(self.state.device)
            mean, var, draw = _engine_step(self.state, nodes, self.generator)
            mean, var, draw = (x.cpu().numpy() for x in (mean, var, draw))
        obs.inc("serving.queries_served", len(live))
        obs.observe("serving.wave.fill", fill)
        for i in live:
            req, pos = self.slots[i]
            req.mean[pos] = mean[i]
            req.var[pos] = var[i]
            req.draw[pos] = draw[i]
            req.answered += 1
            if req.answered == len(req.nodes):
                req.done = True
            self.slots[i] = None
        return len(live)

    def drain(self, progress=None) -> int:
        """Run the admit/step loop until the pending queue and every slot
        are empty; returns the number of queries answered."""
        served = 0
        while self.pending or any(s is not None for s in self.slots):
            while self.pending and self.admit(self.pending[0]):
                self.pending.popleft()
            obs.gauge("serving.queue_depth", len(self.pending))
            n = self.step()
            served += n
            if progress:
                progress(n, len(self.pending))
        return served

    def run(self, requests: list[GPRequest], progress=None):
        """Enqueue ``requests`` (ignoring ``max_pending``) and drain."""
        self.pending.extend(requests)
        self.drain(progress)
        return requests


def thompson_draw(
    state: ServeState,
    nodes,
    generator: torch.Generator,
    n_samples: int = 1,
) -> torch.Tensor:
    """Exact joint posterior samples at ``nodes`` — returns [q, n_samples].

    Draws from N(μ, Σ) with Σ = K̂_qq − VᵀV (V = L⁻¹K̂_{x,q}) via a dense
    q×q Cholesky: O(q·m² + q³), no CG, nothing N-scale.  The standard
    normals come from ``generator``."""
    nodes = _as_tensor(nodes, torch.int32, state.device)
    with obs.span("serving.thompson_draw", q=int(nodes.shape[0]),
                  n_samples=n_samples) as sp:
        trace_q, vals_q, mean, v = _cross_solve(state, nodes)
        eps = _normals(generator, (nodes.shape[0], n_samples), state.device)
        out = _joint_draw_tail(trace_q, vals_q, mean, v, eps)
        sp.block_on(out)
    return out


def _joint_draw_tail(trace_q, vals_q, mean, v, eps):
    """Exact joint MVN draw from the whitened cross-block, given standard
    normals ``eps`` [q, n_samples]."""
    k_qq = dispatch.gram_block(vals_q, trace_q.cols, vals_q, trace_q.cols)
    cov = k_qq - v.T @ v
    # Estimator noise can leave tiny negative eigenvalues; a diagonal
    # jitter scaled to the prior variance keeps the q×q Cholesky SPD.
    jitter = 1e-6 * torch.clamp(torch.max(torch.diagonal(k_qq)), min=1.0)
    eye = torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
    l_post, ok = cholesky_checked(cov + jitter * eye)
    # Guarded draw: if the jittered Cholesky still fails, fall back to
    # independent marginal draws diag(sqrt(clamped var)) instead of NaN.
    if obs.enabled():
        obs.tap("serving.thompson.cov_fallback", ~ok, kind="counter")
    marginal = torch.diag(torch.sqrt(torch.clamp(torch.diagonal(cov), min=0.0)))
    l_post = torch.where(ok, l_post, marginal)
    return mean[:, None] + l_post @ eps
