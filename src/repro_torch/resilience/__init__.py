"""Fault tolerance for the serving and solver stack (port of
``repro/resilience``).

Four pieces, layered from injection to recovery:

  * :mod:`~repro_torch.resilience.faults` — deterministic fault injection
    (``REPRO_FAULTS``); no tensor op when no plan is active;
  * the solve-escalation ladder lives in :mod:`repro_torch.solvers.escalate`
    (``solvers.solve(..., escalate=True)``);
  * guarded serving updates live in :mod:`repro_torch.serving.update`
    (the overflow / rejected / needs_refit flags on ``ServeState``);
  * :mod:`~repro_torch.resilience.journal` /
    :mod:`~repro_torch.resilience.server` — write-ahead journal, crash
    recovery, and the journalled front end.

``journal`` and ``server`` sit *above* serving in the layer order, while
``faults`` sits below it (serving's hot paths call the injection hooks):
they are lazy attributes here, so importing serving never re-enters this
package mid-initialisation.
"""
from . import faults  # noqa: F401
from .faults import (  # noqa: F401
    KILL_EXIT_CODE,
    FaultPlan,
    active,
    fault_scope,
    kill_point,
    parse_faults,
    reset_faults,
    set_faults,
    use_faults,
)

_LAZY = {
    "journal": ".journal",
    "server": ".server",
    "Journal": ".journal",
    "read_journal": ".journal",
    "replay": ".journal",
    "recover": ".journal",
    "ResilientServer": ".server",
}

__all__ = [
    "FaultPlan", "KILL_EXIT_CODE", "active", "fault_scope", "faults",
    "kill_point", "parse_faults", "reset_faults", "set_faults", "use_faults",
    "journal", "server", "Journal", "read_journal", "replay", "recover",
    "ResilientServer",
]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name], __name__)
        if name in ("journal", "server"):
            return mod
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
