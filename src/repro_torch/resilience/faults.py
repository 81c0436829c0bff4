"""Deterministic fault injection for the serving and solver stack (port of
``repro/resilience/faults.py``).

A :class:`FaultPlan` describes which failures to inject where:

  * ``nan_payload`` / ``inf_payload`` — poison the lazily sampled walk
    payload rows (the only N-scale input of the serving hot path) with
    NaN/Inf at a per-node deterministic rate;
  * ``chol_fail`` — corrupt the Schur complement of a fraction of
    incremental Cholesky appends (drives the guarded-append → refit
    fallback in serving/update.py);
  * ``cg_stall`` — force the first k attempts of every *escalated* solve to
    report non-convergence (drives the solve-escalation ladder in
    solvers/escalate.py);
  * ``kill_at`` — ``os._exit`` the process at the k-th :func:`kill_point`
    event (drives the write-ahead-journal crash-recovery tests).

Resolution is the JAX package's: :func:`use_faults` context >
:func:`set_faults` global > ``REPRO_FAULTS`` env var > no faults.  The env
spec is a comma-separated ``name:value`` list, e.g.
``REPRO_FAULTS=nan_payload:0.01,cg_stall:1``.

**No plan, no work.** With no plan active every hook returns the object it
was given and issues no tensor operation — the port's form of the JAX
package's byte-identical HLO.  With a plan, the hooks' counters
(``faults.nan_payload.injected``, ``faults.chol_fail.injected``,
``serving.query.sanitized``) go through ``obs.tap`` only when obs is
enabled, so a disabled obs reads nothing from the device.  The port has no
trace, so :func:`fault_scope` is :func:`use_faults` under the JAX name.

Injection is **deterministic**: payload and append corruption is keyed on
the absolute node id hashed with ``plan.seed`` by :func:`_hash01`, which is
bit-equal to the JAX package's, so both packages poison the same rows and a
replayed traffic stream hits the same faults.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from contextvars import ContextVar

import torch

from ..kernels.walk_sampler.rng import _MASK, _mul32

# Exit code of kill_at, so a parent can tell an injected kill from a
# genuine crash (any other non-zero status).
KILL_EXIT_CODE = 113

_FIELDS = (
    "nan_payload", "inf_payload", "chol_fail", "cg_stall", "kill_at", "seed",
)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What to break, how often (frozen, scalar fields: hashable).

    Attributes:
      nan_payload: probability a sampled walk row's payload is NaN-poisoned.
      inf_payload: probability a sampled walk row's payload is Inf-poisoned.
      chol_fail: probability an incremental append's Schur complement is
        corrupted to a near-zero value (forces the guarded-append refit
        fallback).
      cg_stall: force the first ``cg_stall`` attempts of every escalated
        solve to report non-convergence (0 = off).
      kill_at: ``os._exit(KILL_EXIT_CODE)`` at the ``kill_at``-th
        :func:`kill_point` event (1-based; -1 = off).
      seed: mixes into the per-node corruption hash.
    """

    nan_payload: float = 0.0
    inf_payload: float = 0.0
    chol_fail: float = 0.0
    cg_stall: int = 0
    kill_at: int = -1
    seed: int = 0

    def __post_init__(self):
        for name in ("nan_payload", "inf_payload", "chol_fail"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be a probability, got {v!r}")
        if self.cg_stall < 0:
            raise ValueError(f"cg_stall must be >= 0, got {self.cg_stall}")

    @property
    def corrupts_payload(self) -> bool:
        return self.nan_payload > 0 or self.inf_payload > 0

    @property
    def corrupts_schur(self) -> bool:
        return self.chol_fail > 0

    def spec(self) -> str:
        """The ``name:value`` spec string this plan round-trips through."""
        defaults = FaultPlan()
        return ",".join(f"{name}:{getattr(self, name)}" for name in _FIELDS
                        if getattr(self, name) != getattr(defaults, name))


def parse_faults(spec: str) -> FaultPlan | None:
    """``"nan_payload:0.01,cg_stall:1"`` → :class:`FaultPlan` (None when
    the spec is empty/"off").  Unknown names raise with the valid set — a
    typoed chaos run must fail loudly, not run clean."""
    spec = (spec or "").strip()
    if not spec or spec.lower() in ("0", "off", "none", "false"):
        return None
    kw: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(
                f"fault spec entry {part!r} is not name:value; valid names: "
                f"{_FIELDS}"
            )
        name, _, raw = part.partition(":")
        name = name.strip()
        if name not in _FIELDS:
            raise ValueError(f"unknown fault {name!r}; valid names: {_FIELDS}")
        kw[name] = (int(raw) if name in ("cg_stall", "kill_at", "seed")
                    else float(raw))
    return FaultPlan(**kw)


# ---------------------------------------------------------------------------
# Resolution: context > global > REPRO_FAULTS env > off.  The context layer
# tells "unset" (fall through) from an explicit None pin (use_faults(None)
# means *no faults*, whatever the env says).
# ---------------------------------------------------------------------------

_UNSET = object()
_global_plan: FaultPlan | None | object = _UNSET
_override: ContextVar = ContextVar("repro_torch_faults", default=_UNSET)


def active() -> FaultPlan | None:
    """Resolve the active fault plan (context > global > env > None)."""
    ov = _override.get()
    if ov is not _UNSET:
        return ov
    if _global_plan is not _UNSET:
        return _global_plan
    return parse_faults(os.environ.get("REPRO_FAULTS", ""))


def set_faults(plan: FaultPlan | str | None) -> None:
    """Set the process-global fault plan (a spec string is parsed)."""
    global _global_plan
    if isinstance(plan, str):
        plan = parse_faults(plan)
    _global_plan = plan


def reset_faults() -> None:
    """Restore env-var/default resolution (mainly for tests)."""
    global _global_plan
    _global_plan = _UNSET
    reset_kill_counter()


@contextlib.contextmanager
def use_faults(plan: FaultPlan | str | None):
    """Scoped fault plan override (a spec string is parsed; None disables)."""
    if isinstance(plan, str):
        plan = parse_faults(plan)
    token = _override.set(plan)
    try:
        yield plan
    finally:
        _override.reset(token)


def fault_scope(plan: FaultPlan | None):
    """Pin :func:`active` to exactly ``plan`` for a block.  The JAX package
    pins a trace with it; the port has no trace, so this is
    :func:`use_faults`."""
    return use_faults(plan)


# ---------------------------------------------------------------------------
# Tensor hooks.  No plan active: the input object back, no tensor op.
# ---------------------------------------------------------------------------


def _hash01(x: torch.Tensor, seed: int) -> torch.Tensor:
    """Deterministic per-id uniform in [0, 1], bit-equal to the JAX
    package's: the same fmix-style mix of the absolute node id with the
    plan seed, on int64 tensors holding uint32 values (PyTorch on the CPU
    has no uint32 shifts), with the walk RNG's overflow-free 32-bit
    multiply.  The final uint32 → float32 conversion rounds to nearest, as
    ``astype(float32)`` does, so u can be exactly 1.0."""
    mix = (seed * 0x9E3779B9 + 0x85EBCA6B) & _MASK
    x = (x.to(torch.int64) & _MASK) ^ mix
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x.to(torch.float32) * (1.0 / 4294967296.0)


def corrupt_loads(loads: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
    """NaN/Inf-poison whole payload rows at the plan's per-node rate (NaN
    rows first, then Inf rows).

    Called from the lazy row sampler (serving.state.query_rows); returns
    ``loads`` itself when no plan corrupts payloads."""
    plan = active()
    if plan is None or not plan.corrupts_payload:
        return loads
    from .. import obs

    u = _hash01(nodes.to(loads.device), plan.seed)
    bad_nan = u < plan.nan_payload
    bad_inf = (u >= plan.nan_payload) & (
        u < plan.nan_payload + plan.inf_payload)
    if obs.enabled():
        obs.tap("faults.nan_payload.injected",
                torch.sum(bad_nan | bad_inf).to(torch.int32), kind="counter")
    loads = torch.where(bad_nan[:, None], float("nan"), loads)
    return torch.where(bad_inf[:, None], float("inf"), loads)


def corrupt_schur(d2: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """Corrupt the append's Schur complement to a near-zero negative value
    at the plan's per-node rate — the injected stand-in for catastrophic
    float32 cancellation on near-duplicate observations."""
    plan = active()
    if plan is None or not plan.corrupts_schur:
        return d2
    from .. import obs

    bad = _hash01(node.reshape(1), plan.seed + 1)[0] < plan.chol_fail
    if obs.enabled():
        obs.tap("faults.chol_fail.injected", bad.to(torch.int32),
                kind="counter")
    return torch.where(bad, torch.full_like(d2, -1e-6), d2)


def guard_trace(trace):
    """Sanitise a lazily sampled query trace: zero any non-finite payload
    row, so a poisoned query degrades to the prior prediction for that node
    instead of propagating NaN through the whole wave.

    Applied only when a plan corrupts payloads: the query path is left as
    it is otherwise (the estimator is PSD by construction, so non-finites
    that were not injected are bugs the append guards catch)."""
    plan = active()
    if plan is None or not plan.corrupts_payload:
        return trace
    from .. import obs
    from ..core.walks import WalkTrace

    ok = torch.all(torch.isfinite(trace.loads), dim=1)
    if obs.enabled():
        obs.tap("serving.query.sanitized", torch.sum(~ok).to(torch.int32),
                kind="counter")
    return WalkTrace(cols=trace.cols,
                     loads=torch.where(ok[:, None], trace.loads, 0.0),
                     lens=trace.lens)


# ---------------------------------------------------------------------------
# Host-level faults: solve stalls and process kills.
# ---------------------------------------------------------------------------


def should_stall(attempt: int) -> bool:
    """True when the active plan forces escalated-solve ``attempt``
    (0-based) to report non-convergence.  ``cg_stall:k`` stalls the first
    k attempts of *every* escalated solve, so the ladder resolves each
    stall in exactly k extra rungs."""
    plan = active()
    return plan is not None and attempt < plan.cg_stall


_kill_events = 0


def reset_kill_counter() -> None:
    global _kill_events
    _kill_events = 0


def kill_events() -> int:
    """How many kill-point events the active plan has counted so far."""
    return _kill_events


def kill_point(name: str) -> None:
    """Crash site: with ``kill_at:k`` active, the k-th call (1-based,
    process-wide) exits hard with :data:`KILL_EXIT_CODE` — no atexit, no
    flushing: the SIGKILL stand-in the journal recovery tests replay
    against.  Free when no plan sets ``kill_at``."""
    plan = active()
    if plan is None or plan.kill_at < 0:
        return
    global _kill_events
    _kill_events += 1
    if _kill_events == plan.kill_at:
        sys.stderr.write(f"[faults] kill_at={plan.kill_at} hit at {name!r}\n")
        sys.stderr.flush()
        os._exit(KILL_EXIT_CODE)
