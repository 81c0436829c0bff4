"""Incremental ServeState updates: Cholesky row-append / downdate / refit
(port of ``repro/serving/update.py``).

  * :func:`observe` / :func:`observe_batch` — appending observation m+1 is
    one lazy walk launch for its row, one cross-Gram row (``gram_block``),
    one forward triangular solve and, once per batch, an α re-solve:
    O(m²) per observation.
  * :func:`forget` — removing observation p is a shift plus a rank-1
    Cholesky *update* of the trailing block (LINPACK dchud), O(m²).
  * :func:`refit` / :func:`ingest` — the O(m³) from-scratch
    refactorisation, used when hyperparameters change and as the parity
    reference of the incremental paths.

Updates are functional: they return a new state and leave the input's
tensors as they were.  The dead block of the Cholesky is the identity and
dead feature rows carry zero loads, so every full-size solve and Gram is
exact.  The JAX ``lax.scan`` over appends is a Python loop: one walk launch
and one ``gram_block`` launch per append, with the health checks kept on the
device (masked writes, no host read inside the loop).

The fleet's async paths, :func:`observe_batch_async` and
:func:`forget_batch_async`, read nothing back to the host.  PyTorch has no
buffer donation, so their ``donate=True`` (and :func:`refit_alpha`'s) takes
the in-place form of it: the new values are written into the input state's
mutable tensors (``nodes``, ``y``, ``count``, the trace's three, ``chol``,
``alpha`` and the flags), and the returned state holds those very tensors.
After a donated call the old state object reads the new values; the graph,
``f`` and ``σ²`` are never written.

``torch.linalg.cholesky`` raises where ``jnp.linalg.cholesky`` returns NaN,
so the factorisations use ``torch.linalg.cholesky_ex`` and treat a non-zero
``info`` or a non-finite factor as the failure the JAX jitter ladder tests
for.

Observability (when ``obs`` is enabled): the ``serving.observe_batch``,
``serving.evict``, ``serving.ingest``, ``serving.refit`` and
``serving.refit_alpha`` spans, and the ``serving.observations``,
``serving.observe.*`` and ``serving.refit.fallback`` counters of the JAX
package; the flag reads behind the overflow and rejection counters are
made only then.  :func:`refit_alpha`'s ladder emits one
``solver.escalation`` event per attempt (``site: "serving.refit_alpha"``)
and the ``solver.escalation.*`` counters.

Fault injection (``resilience.faults``): the append's Schur complement is
a ``corrupt_schur`` site, the lazily sampled rows are poisoned by
``query_rows``, and :func:`ingest` — the from-scratch parity reference,
with no incremental guard to catch a corrupted bulk load — runs with the
plan pinned off.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import obs, solvers
from ..core import features
from ..core.walks import WalkTrace
from ..kernels import dispatch
from ..resilience import faults
from ..solvers import SolveStrategy
from .state import ServeState, query_rows, solve_chol, solve_lower

# Overflow handling when observe_batch would exceed capacity.
OVERFLOW_POLICIES = ("raise", "forget_oldest", "reject")

# An append whose Schur complement is below this fraction of its prior
# scale k_nn + σ² is running on jitter: the row is near-linearly-dependent
# on the live block, and the O(m³) refit fallback owns it.
_TINY_SCHUR_FRAC = 1e-5

# The leaves an update changes; the rest (graph, f, σ², seed, cfg) stay.
# A checkpoint of the state holds these, in this order.
_MUTABLE = ("nodes", "y", "count", "trace", "chol", "alpha",
            "overflow", "rejected", "needs_refit")


def _pack(state: ServeState) -> tuple:
    return tuple(getattr(state, k) for k in _MUTABLE)


def _unpack(state: ServeState, packed) -> ServeState:
    return dataclasses.replace(state, **dict(zip(_MUTABLE, packed)))


def _as_tensor(x, dtype, dev) -> torch.Tensor:
    """``x`` (tensor, array, list or scalar) as a flat tensor on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype).reshape(-1)
    return torch.as_tensor(np.asarray(x)).to(device=dev,
                                             dtype=dtype).reshape(-1)


def _to_device_async(x, dtype, dev) -> torch.Tensor:
    """``x`` as a flat tensor on ``dev`` without a host synchronisation: an
    array goes through pinned memory and a non-blocking copy on the card (a
    copy from pageable memory may wait for the stream)."""
    if isinstance(x, torch.Tensor) and x.device == dev:
        return x.to(dtype).reshape(-1)
    t = torch.as_tensor(np.asarray(
        x.cpu() if isinstance(x, torch.Tensor) else x)).to(dtype).reshape(-1)
    if dev.type != "cuda":
        return t.clone()
    return t.pin_memory().to(dev, non_blocking=True)


def copy_mutable(state: ServeState) -> ServeState:
    """``state`` with private copies of its mutable tensors: what a donated
    update may write without reaching another state (a functional update
    shares the leaves it leaves unchanged with its input)."""
    return _unpack(state, [
        WalkTrace(x.cols.clone(), x.loads.clone(), x.lens.clone())
        if isinstance(x, WalkTrace) else x.clone() for x in _pack(state)])


def _donate(state: ServeState, new: ServeState) -> ServeState:
    """The in-place form of donation: write ``new``'s mutable leaves into
    ``state``'s tensors and return ``new`` holding ``state``'s tensors."""
    out = {}
    for name in _MUTABLE:
        old, fresh = getattr(state, name), getattr(new, name)
        if name == "trace":
            for f in ("cols", "loads", "lens"):
                getattr(old, f).copy_(getattr(fresh, f))
        else:
            old.copy_(fresh)
        out[name] = old
    return dataclasses.replace(new, **out)


def cholesky_checked(a: torch.Tensor):
    """(L, ok): the lower Cholesky factor, row-major, and a 0-d bool tensor
    that is True when it succeeded — no host read, no exception.

    ``cholesky_ex`` returns a column-major factor; every state leaf is kept
    row-major, so that a state's arithmetic does not depend on which update
    made it and a broadcast of its raw memory (serving/sharded.py) lands in
    the same layout on every rank."""
    chol, info = torch.linalg.cholesky_ex(a)
    chol = chol.contiguous()
    return chol, (info == 0) & torch.all(torch.isfinite(chol))


def _factorize(vals_x, cols_x, live, sigma_n2):
    """Lower Cholesky of [K̂_xx + σ²I on live; I on dead] (block-diagonal).

    A jittered retry ladder backs the plain factorisation: when duplicate or
    near-duplicate observations make the live Gram numerically singular,
    it retries with escalating diagonal jitter on the live block.  Each
    rung is tried only while every earlier one failed (one host read per
    rung).  If all fail, the factor is NaN, as in the JAX package."""
    gram = dispatch.gram_block(vals_x, cols_x, vals_x, cols_x)
    ones = torch.ones_like(live)
    a = gram + torch.diag(torch.where(live > 0, sigma_n2 * ones, ones))
    chol, ok = cholesky_checked(a)
    scale = torch.clamp(torch.max(torch.diagonal(a)), min=1.0)
    for eps in (1e-6, 1e-4, 1e-2):
        if bool(ok):
            break
        chol, ok = cholesky_checked(a + (eps * scale) * torch.diag(live))
    return torch.where(ok, chol, torch.full_like(chol, float("nan")))


def _refit_impl(state: ServeState) -> ServeState:
    chol = _factorize(state.vals(), state.trace.cols, state.live_mask(),
                      state.sigma_n2)
    return dataclasses.replace(
        state, chol=chol, alpha=solve_chol(chol, state.y),
        needs_refit=torch.zeros_like(state.needs_refit),
    )


def _append(state: ServeState, node: torch.Tensor, y_t: torch.Tensor) -> ServeState:
    """One *guarded* Cholesky row-append at position m = count (O(m²)).

    Three device-side checks decide what the masked writes do; none reads
    back to the host, all report through the ServeState flags:

      * non-finite row (payload, target or Schur complement) — the append
        is **rejected**: no write, ``rejected`` bumps;
      * at capacity — the append is **dropped**: no write, ``overflow``
        bumps;
      * near-zero Schur complement — the row **is written** under a jitter
        clamp so the factor stays SPD, and ``needs_refit`` bumps."""
    dev = state.device
    idx = torch.arange(state.capacity, device=dev)
    m = state.count
    trace1 = query_rows(state, node.reshape(1))
    vals1 = features.feature_values(trace1, state.f)
    k_vec = dispatch.gram_block(
        vals1, trace1.cols, state.vals(), state.trace.cols
    )[0]                                      # [capacity]; 0 on dead slots
    k_nn = features.khat_diag_exact(trace1, state.f)[0]
    ell = solve_lower(state.chol, k_vec)
    d2 = k_nn + state.sigma_n2 - torch.dot(ell, ell)
    d2 = faults.corrupt_schur(d2, node)       # injection site (off: no-op)
    finite = (torch.isfinite(k_nn) & torch.all(torch.isfinite(k_vec))
              & torch.isfinite(y_t) & torch.isfinite(d2))
    over = m >= state.capacity
    floor = _TINY_SCHUR_FRAC * (k_nn + state.sigma_n2)
    tiny = d2 <= floor
    write = finite & ~over
    # Jitter clamp relative to the row's own scale.
    d = torch.sqrt(torch.maximum(d2, floor))
    row = torch.where(idx < m, ell, torch.zeros_like(ell))
    row = torch.where(idx == m, d, row)
    sel = (idx == m) & write
    one, zero = torch.ones_like(m), torch.zeros_like(m)
    sel2 = sel[:, None]
    return dataclasses.replace(
        state,
        nodes=torch.where(sel, node.to(torch.int32), state.nodes),
        y=torch.where(sel, y_t, state.y),
        count=m + torch.where(write, one, zero),
        trace=WalkTrace(
            cols=torch.where(sel2, trace1.cols[0], state.trace.cols),
            loads=torch.where(sel2, trace1.loads[0], state.trace.loads),
            lens=torch.where(sel2, trace1.lens[0], state.trace.lens),
        ),
        chol=torch.where(sel2, row[None, :], state.chol),
        overflow=state.overflow + torch.where(finite & over, one, zero),
        rejected=state.rejected + torch.where(finite, zero, one),
        needs_refit=state.needs_refit + torch.where(write & tiny, one, zero),
    )


def _evict_oldest(state: ServeState, room: int) -> ServeState:
    """Make ``room`` slots by forgetting the oldest live observations."""
    return forget_batch(state, [0] * min(room, int(state.count)))


def observe_batch(
    state: ServeState,
    nodes,
    ys,
    *,
    on_overflow: str = "raise",
    auto_refit: bool = True,
) -> ServeState:
    """Append a batch of observations by sequential *guarded* Cholesky
    row-appends; α is re-solved once at the end.

    ``on_overflow`` picks the degradation when the batch would exceed
    capacity: ``"raise"`` (ValueError before touching the state),
    ``"forget_oldest"`` (evict the oldest observations by rank-1 downdates,
    then append everything) or ``"reject"`` (append until full, drop the
    excess, bump ``state.overflow``).  Non-finite appends are rejected
    row-wise (``state.rejected``); near-singular appends are jitter-clamped
    and, with ``auto_refit=True``, answered by an O(m³) :func:`refit`."""
    if on_overflow not in OVERFLOW_POLICIES:
        raise ValueError(
            f"unknown on_overflow {on_overflow!r}; valid: {OVERFLOW_POLICIES}"
        )
    dev = state.device
    nodes = _as_tensor(nodes, torch.int32, dev)
    ys = _as_tensor(ys, torch.float32, dev)
    excess = int(state.count) + nodes.shape[0] - state.capacity
    if excess > 0:
        if on_overflow == "raise":
            raise ValueError(
                f"observing {nodes.shape[0]} more would exceed serving "
                f"capacity {state.capacity} (count={int(state.count)}); "
                "build the state with a larger capacity, or pass "
                "on_overflow='forget_oldest'/'reject' to degrade gracefully"
            )
        if on_overflow == "forget_oldest":
            with obs.span("serving.evict", n=excess):
                state = _evict_oldest(state, excess)
            obs.inc("serving.observe.evictions", excess)
    with obs.span("serving.observe_batch", n=int(nodes.shape[0])) as sp:
        new = state
        for i in range(nodes.shape[0]):
            new = _append(new, nodes[i], ys[i])
        if obs.enabled():
            obs.tap("serving.observe.overflow", new.overflow - state.overflow,
                    kind="counter")
        new = dataclasses.replace(new, alpha=solve_chol(new.chol, new.y))
        sp.block_on(new)
    obs.inc("serving.observations", int(nodes.shape[0]))
    if obs.enabled():
        dropped = int(new.overflow) - int(state.overflow)
        if dropped:
            obs.inc("serving.observe.overflow", dropped)
        rej = int(new.rejected) - int(state.rejected)
        if rej:
            obs.inc("serving.observe.rejected", rej)
    if auto_refit and int(new.needs_refit) > 0:
        # The incremental factor is running on jitter: refactorise.
        obs.inc("serving.refit.fallback")
        new = refit(new)
    return new


def observe(state: ServeState, node, y, **kwargs) -> ServeState:
    """Append one observation: O(m²), no CG, nothing N-scale."""
    return observe_batch(state, [node], [y], **kwargs)


def observe_batch_async(state: ServeState, nodes, ys, *,
                        donate: bool = True) -> ServeState:
    """Dispatch a guarded batched append with **no host synchronisation**.

    The fleet's mutation path: :func:`observe_batch` reads ``count`` before
    it appends and the flags after, each a full synchronisation that
    serialises the wave pipeline.  This variant only enqueues work.
    Overflow behaves like ``on_overflow="reject"`` (the masked drop,
    reported by the ``overflow`` flag), nothing is refitted here, and the
    caller reads the health flags later, where it blocks anyway
    (``GPFleetLoop._check_flags``).  The result equals
    ``observe_batch(state, nodes, ys, on_overflow="reject",
    auto_refit=False)`` bit for bit.

    ``donate=True`` (in-place, see the module docstring): the new values are
    written into ``state``'s mutable tensors and the returned state holds
    them, so **after the call the old state object reads the new values**
    — keep using the returned one.  Any other state that shares those
    tensors (a functional update shares the leaves it did not change) reads
    them too: donate only a state whose tensors are its own
    (:func:`copy_mutable`).  ``donate=False`` leaves ``state`` as it was."""
    dev = state.device
    nodes = _to_device_async(nodes, torch.int32, dev)
    ys = _to_device_async(ys, torch.float32, dev)
    new = state
    for i in range(nodes.shape[0]):
        new = _append(new, nodes[i], ys[i])
    if obs.enabled():
        obs.tap("serving.observe.overflow", new.overflow - state.overflow,
                kind="counter")
    new = dataclasses.replace(new, alpha=solve_chol(new.chol, new.y))
    obs.inc("serving.observations", int(nodes.shape[0]))
    return _donate(state, new) if donate else new


def _cholupdate(chol: torch.Tensor, x: torch.Tensor, start: int = 0,
                stop: int | None = None) -> torch.Tensor:
    """L̃ with L̃L̃ᵀ = LLᵀ + xxᵀ (LINPACK dchud, columns swept in order).

    Only columns [start, stop) are swept: a column where x is already zero
    is an exact no-op (cos = 1, sin = 0), and rows are updated elementwise,
    so a caller that knows x vanishes outside that range skips nothing that
    changes the result.  Dead diagonal entries are 1, never 0."""
    ell = chol.clone()
    x = x.clone()
    idx = torch.arange(chol.shape[0], device=chol.device)
    stop = chol.shape[0] if stop is None else stop
    for k in range(start, stop):
        lkk, xk = ell[k, k], x[k]
        r = torch.sqrt(lkk * lkk + xk * xk)
        cos, sin = r / lkk, xk / lkk
        below = idx > k
        col = ell[:, k]
        newcol = torch.where(below, (col + sin * x) / cos, col)
        newcol[k] = r
        x = torch.where(below, cos * x - sin * newcol, x)
        ell[:, k] = newcol
    return ell


def _forget_step(state: ServeState, slot: int, count,
                 stop: int | None = None) -> ServeState:
    """One downdate of the observation in buffer position ``slot``, α left
    stale (the caller re-solves it once after a run of forgets).

    ``count`` is the live count before the step: a host int (the sweep then
    stops at the new count) or the state's 0-d device tensor (no host read:
    the sweep runs to ``stop``, by default capacity — its columns past the
    new count touch only the dead block, which the identity then
    overwrites — so any ``stop`` at or above the new count gives the same
    result, bit for bit)."""
    c = state.capacity
    dev = state.device
    idx = torch.arange(c, device=dev)
    # Shift everything after `slot` up one position (dead fill at the top).
    src = torch.where(idx >= slot, torch.clamp(idx + 1, max=c - 1), idx)
    chol = state.chol
    # Removing row/col `slot` de-factors its outer product: the trailing
    # block satisfies L̃L̃ᵀ = L'L'ᵀ + SSᵀ with S = L[slot+1:, slot].
    x = torch.where(idx >= slot, chol[:, slot][src], torch.zeros_like(idx,
                    dtype=chol.dtype))
    new_count = count - 1
    on_host = isinstance(new_count, int)
    if on_host:
        stop = new_count
    elif stop is None:
        stop = c
    new_chol = _cholupdate(chol[src][:, src], x, start=slot, stop=stop)
    dead = idx >= new_count
    new_chol = torch.where(dead[:, None] | dead[None, :],
                           torch.eye(c, dtype=new_chol.dtype, device=dev),
                           new_chol)
    live = ~dead
    live2 = live[:, None]
    tr = state.trace
    return dataclasses.replace(
        state,
        nodes=torch.where(live, state.nodes[src], 0),
        y=torch.where(live, state.y[src], 0.0),
        count=(torch.full_like(state.count, new_count) if on_host
               else new_count),
        trace=WalkTrace(
            cols=torch.where(live2, tr.cols[src], 0),
            loads=torch.where(live2, tr.loads[src], 0.0),
            lens=torch.where(live2, tr.lens[src], 0),
        ),
        chol=new_chol,
    )


def forget(state: ServeState, slot: int) -> ServeState:
    """Remove the observation in buffer position ``slot`` (0 ≤ slot < count).

    Rank-1 Cholesky downdate of the stored factor — O(m²), no
    refactorisation.  Later observations shift up one slot."""
    return forget_batch(state, [slot])


def forget_batch(state: ServeState, slots) -> ServeState:
    """Apply a sequence of forgets, then re-solve α once.

    Slot indices are interpreted sequentially, i.e. against the buffer
    layout *after* the preceding forgets in the batch (``[0, 0]`` drops the
    two oldest observations)."""
    slots = [int(s) for s in np.asarray(
        slots.cpu() if isinstance(slots, torch.Tensor) else slots).reshape(-1)]
    count = int(state.count)
    for s in slots:
        if not 0 <= s < count:
            raise ValueError(f"forget slot {s} outside the live block "
                             f"[0, {count})")
        state = _forget_step(state, s, count)
        count -= 1
    return dataclasses.replace(state, alpha=solve_chol(state.chol, state.y))


def forget_batch_async(state: ServeState, slots, *, donate: bool = True,
                       live_bound: int | None = None) -> ServeState:
    """:func:`forget_batch` with no host synchronisation — the fleet's
    forget path, one call per run of queued forgets.

    ``count`` is never read: each downdate takes the dead mask from the
    device count and sweeps its columns up to a bound on the live count
    instead of to the count itself — ``live_bound``, one the caller knows
    without reading the device (the fleet keeps one: an append raises the
    count by at most one, a forget lowers it by one), or capacity.  Any
    bound at or above the count gives :func:`forget_batch`'s result bit
    for bit.  The slots are not checked against the live count (that would
    read it); each must lie in the live block, as in :func:`forget_batch`.
    Same donation contract as :func:`observe_batch_async`: with
    ``donate=True`` the old state object reads the new values."""
    slots = [int(s) for s in np.asarray(
        slots.cpu() if isinstance(slots, torch.Tensor) else slots).reshape(-1)]
    bound = state.capacity if live_bound is None else min(live_bound,
                                                          state.capacity)
    new, count = state, state.count
    for s in slots:
        bound -= 1
        new = _forget_step(new, s, count, stop=max(bound, 0))
        count = new.count
    new = dataclasses.replace(new, alpha=solve_chol(new.chol, new.y))
    return _donate(state, new) if donate else new


def ingest(state: ServeState, nodes, ys) -> ServeState:
    """Replace the whole observation set and refactorise once (O(m³)).

    The from-scratch entry point: BO init sets, hyperparameter refits that
    also change the data, and the parity reference for the incremental
    appends."""
    dev = state.device
    nodes = _as_tensor(nodes, torch.int32, dev)
    ys = _as_tensor(ys, torch.float32, dev)
    count = nodes.shape[0]
    if count > state.capacity:
        raise ValueError(
            f"{count} observations exceed serving capacity {state.capacity}"
        )
    pad = state.capacity - count
    nodes = torch.cat([nodes, nodes.new_zeros(pad)])
    ys = torch.cat([ys, ys.new_zeros(pad)])
    with obs.span("serving.ingest", n=count) as sp, faults.use_faults(None):
        trace = query_rows(state, nodes)
        live = torch.arange(state.capacity, device=dev) < count
        state = dataclasses.replace(
            state,
            nodes=torch.where(live, nodes, 0),
            y=torch.where(live, ys, 0.0),
            count=torch.full_like(state.count, count),
            trace=WalkTrace(cols=trace.cols, loads=trace.loads * live[:, None],
                            lens=trace.lens),
        )
        state = _refit_impl(state)
        sp.block_on(state)
    obs.inc("serving.observations", count)
    return state


def _with_hypers(state: ServeState, f=None, sigma_n2=None, y=None) -> ServeState:
    updates = {}
    dev = state.device
    if f is not None:
        updates["f"] = torch.as_tensor(f, dtype=torch.float32).to(dev)
    if sigma_n2 is not None:
        updates["sigma_n2"] = torch.as_tensor(sigma_n2,
                                              dtype=torch.float32).to(dev)
    if y is not None:
        updates["y"] = torch.as_tensor(y, dtype=torch.float32).to(dev)
    return dataclasses.replace(state, **updates) if updates else state


def refit(state: ServeState, f=None, sigma_n2=None, y=None) -> ServeState:
    """From-scratch refactorisation of the live block (O(m³)).

    Use after hyperparameter updates (new ``f``/``sigma_n2`` move every Gram
    entry) or to swap the target buffer ``y`` (full capacity, dead slots
    zero).  The cached walk rows do not depend on ``f``: nothing is
    re-sampled."""
    state = _with_hypers(state, f, sigma_n2, y)
    with obs.span("serving.refit") as sp:
        state = _refit_impl(state)
        sp.block_on(state)
    return state


# ---------------------------------------------------------------------------
# Mean-serving fast refit: warm-started strategy solve, no refactorisation.
# ---------------------------------------------------------------------------


def _refit_alpha_impl(state: ServeState, alpha0: torch.Tensor,
                      strategy: SolveStrategy):
    live = state.live_mask()
    vals = state.vals()
    gram = dispatch.gram_block(vals, state.trace.cols, vals, state.trace.cols)
    ones = torch.ones_like(live)
    noise = torch.where(live > 0, state.sigma_n2 * ones, ones)
    a = gram + torch.diag(noise)
    sol = solvers.solve(
        a.__matmul__, state.y, strategy, x0=alpha0,
        precond=None if strategy.preconditioner == "none"
        else solvers.jacobi_precond(torch.diagonal(a)),
    )
    return sol.x, sol.iters, bool(torch.all(sol.converged))


def _alpha_ladder(strategy: SolveStrategy) -> list[SolveStrategy]:
    """The dense-Gram escalation rungs for :func:`refit_alpha`: stronger
    preconditioning first, then iteration budget, warm-started throughout
    (each attempt resumes from the best iterate so far)."""
    rungs = [strategy]
    s = strategy
    if s.preconditioner == "none":
        s = s.with_(preconditioner="jacobi", warm_start=True)
        rungs.append(s)
    for _ in range(2):
        s = s.with_(max_iters=s.max_iters * 4, warm_start=True)
        rungs.append(s)
    return rungs


def refit_alpha(
    state: ServeState,
    f=None,
    sigma_n2=None,
    strategy: SolveStrategy | None = None,
    return_diagnostics: bool = False,
    escalate: bool = False,
    max_attempts: int = 3,
    donate: bool = False,
):
    """Refresh the representer weights α after a hyperparameter move —
    **without** the O(m³) Cholesky refactorisation.

    A warm-started strategy solve of the fresh A(θ_new) α = y from the
    stale α.  Only ``alpha`` is refreshed: the cached Cholesky still
    factorises the *old* A, so variance queries need a full :func:`refit`.
    With ``escalate=True`` a non-converged solve retries up to
    ``max_attempts`` times along :func:`_alpha_ladder` (stronger
    preconditioner, then 4× iteration budgets, warm-started), emitting a
    ``solver.escalation`` obs event per attempt — the serving-side twin of
    ``solvers.solve(..., escalate=True)``; a ``cg_stall`` fault plan forces
    the first attempts to count as stalled.

    ``donate=True`` writes the new α into the caller's ``state.alpha`` in
    place (the in-place form of the JAX package's donation of the
    warm-start buffer): after the call the old state object reads the new
    α."""
    if strategy is None:
        strategy = solvers.SERVING_DEFAULT
    if strategy.preconditioner == "auto":
        # Dense m×m serving Gram: auto's only candidate is Jacobi.
        strategy = strategy.with_(preconditioner="jacobi")
    if strategy.preconditioner == "nystrom":
        raise ValueError(
            "refit_alpha supports preconditioner 'none' or 'jacobi'; the "
            "dense serving Gram has no trace rows for 'nystrom'"
        )
    state = _with_hypers(state, f, sigma_n2)
    rungs = _alpha_ladder(strategy)[:max_attempts] if escalate else [strategy]
    alpha = state.alpha
    with obs.span("serving.refit_alpha") as sp:
        for attempt, s in enumerate(rungs):
            alpha, iters, converged = _refit_alpha_impl(state, alpha, s)
            if not escalate:
                break
            stalled = faults.should_stall(attempt)
            ok = converged and not stalled
            obs.emit_event({
                "type": "solver.escalation", "site": "serving.refit_alpha",
                "attempt": attempt, "converged": ok,
                "forced_stall": stalled, "max_iters": s.max_iters,
                "preconditioner": s.preconditioner,
            })
            obs.inc("solver.escalation.attempts")
            if stalled:
                obs.inc("solver.escalation.forced_stalls")
            if ok:
                if attempt > 0:
                    obs.inc("solver.escalation.resolved")
                break
        else:
            obs.inc("solver.escalation.exhausted")
        sp.block_on(alpha)
    if donate:
        state.alpha.copy_(alpha)
        alpha = state.alpha
    state = dataclasses.replace(state, alpha=alpha)
    if return_diagnostics:
        return state, iters, converged
    return state
