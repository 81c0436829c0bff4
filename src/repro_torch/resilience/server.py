"""The journalled serving front end: WAL + checkpoints + guarded updates
in one object (port of ``repro/resilience/server.py``).

:class:`ResilientServer` wraps a ``ServeState`` with the full durability
discipline so call sites don't have to sequence it by hand:

    journal.log(op)          # write-ahead: the op is durable first
    <kill_point>             # the injectable crash site
    state = apply(op)        # guarded update (overflow policy, auto refit)
    maybe checkpoint         # every checkpoint_every ops, manifest carries
                             # the journal seq it covers

After a crash, :meth:`ResilientServer.recover` rebuilds the state from the
latest checkpoint plus the journal tail and returns a server ready to keep
appending to the *same* journal.  Queries are not journalled (they don't
mutate state) but do pass a kill point, so chaos tests can kill mid-query
too.
"""
from __future__ import annotations

import numpy as np
import torch

from . import faults
from .journal import Journal
from .journal import recover as _recover


def _host(x, dtype) -> np.ndarray:
    """``x`` (tensor, array, list or scalar) as a flat host array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype).reshape(-1)


class ResilientServer:
    """Fault-tolerant serving wrapper: write-ahead journal, periodic
    checkpoints, guarded observe/forget/refit.

    Args:
      state: the live ``ServeState`` (start from ``serving.init_state``).
      journal: a :class:`Journal`, a path to open one, or None (no WAL —
        guards and policies still apply, recovery doesn't).
      on_overflow: capacity policy for observes (``"reject"`` default —
        a long-running server should degrade, not die; see
        ``serving.observe_batch``).
      auto_refit: answer near-singular appends with the O(m³) refit
        fallback (see ``serving.observe_batch``).
      checkpoint_dir / checkpoint_every / keep: write a checkpoint of the
        mutable state leaves every ``checkpoint_every`` journalled ops
        (None = never), keeping the last ``keep``.
    """

    def __init__(
        self,
        state,
        journal: Journal | str | None = None,
        *,
        on_overflow: str = "reject",
        auto_refit: bool = True,
        checkpoint_dir: str | None = None,
        checkpoint_every: int | None = None,
        keep: int = 3,
    ):
        from ..serving import update as _update

        self._update = _update
        self.state = state
        self.journal = (
            Journal(journal) if isinstance(journal, str) else journal
        )
        self.on_overflow = on_overflow
        self.auto_refit = auto_refit
        self.checkpoint_every = checkpoint_every
        self._mgr = None
        if checkpoint_dir is not None:
            from ..checkpoint import CheckpointManager

            self._mgr = CheckpointManager(checkpoint_dir, keep=keep)
        self._ops_since_checkpoint = 0
        latest = self._mgr.latest_step() if self._mgr else None
        self._step = 0 if latest is None else latest + 1

    # -- journalled mutations ------------------------------------------------
    def _log(self, kind: str, **payload) -> None:
        if self.journal is not None:
            self.journal.log(kind, **payload)

    def _after_mutation(self) -> None:
        self._ops_since_checkpoint += 1
        if (
            self._mgr is not None
            and self.checkpoint_every is not None
            and self._ops_since_checkpoint >= self.checkpoint_every
        ):
            self.checkpoint()

    def observe(self, nodes, ys) -> None:
        """Journal, then append a batch of observations (guarded)."""
        nodes = _host(nodes, np.int32)
        ys = _host(ys, np.float32)
        self._log(
            "observe", nodes=nodes.tolist(),
            ys=[float(v) for v in ys],
            on_overflow=self.on_overflow, auto_refit=self.auto_refit,
        )
        faults.kill_point("serving.observe")
        self.state = self._update.observe_batch(
            self.state, nodes, ys,
            on_overflow=self.on_overflow, auto_refit=self.auto_refit,
        )
        self._after_mutation()

    def forget(self, slot: int) -> None:
        """Journal, then drop the observation in buffer ``slot``."""
        self._log("forget", slot=int(slot))
        faults.kill_point("serving.forget")
        self.state = self._update.forget(self.state, int(slot))
        self._after_mutation()

    def refit(self, f=None, sigma_n2=None) -> None:
        """Journal, then refactorise (hyperparameter moves)."""
        payload = {}
        if f is not None:
            payload["f"] = _host(f, np.float32).tolist()
        if sigma_n2 is not None:
            payload["sigma_n2"] = float(sigma_n2)
        self._log("refit", **payload)
        faults.kill_point("serving.refit")
        self.state = self._update.refit(self.state, f=f, sigma_n2=sigma_n2)
        self._after_mutation()

    # -- reads ---------------------------------------------------------------
    def query(self, nodes):
        """Posterior (mean, var) at ``nodes`` — not journalled (no state
        mutation), but a kill point so chaos tests can crash mid-read."""
        from ..serving import posterior_moments

        faults.kill_point("serving.query")
        return posterior_moments(self.state, nodes)

    # -- durability ----------------------------------------------------------
    def checkpoint(self) -> int:
        """Write a blocking checkpoint of the mutable state leaves; the
        manifest records the journal seq it covers, so recovery replays
        only the tail.  Returns the checkpoint step."""
        if self._mgr is None:
            raise ValueError("ResilientServer built without checkpoint_dir")
        seq = self.journal.seq if self.journal is not None else -1
        self._mgr.save(
            self._step, self._update._pack(self.state),
            extra={"journal_seq": seq},
        )
        self._ops_since_checkpoint = 0
        self._step += 1
        return self._step - 1

    def close(self) -> None:
        if self.journal is not None:
            self.journal.close()

    def __enter__(self) -> "ResilientServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @classmethod
    def recover(
        cls,
        example_state,
        journal_path: str,
        checkpoint_dir: str | None = None,
        **kwargs,
    ) -> tuple["ResilientServer", int]:
        """Rebuild from checkpoint + journal tail; returns
        ``(server, n_replayed)``.  The server appends to the same journal
        it replayed (seq numbering resumes)."""
        state, n = _recover(
            example_state, journal_path, checkpoint_dir=checkpoint_dir
        )
        server = cls(
            state, journal=journal_path, checkpoint_dir=checkpoint_dir,
            **kwargs,
        )
        return server, n
