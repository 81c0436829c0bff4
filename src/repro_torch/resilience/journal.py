"""Write-ahead journal + crash recovery for the serving state (port of
``repro/resilience/journal.py``).

The serving ``ServeState`` is a deterministic fold over its update stream:
walk rows are counter-RNG keyed on absolute node ids, so replaying the
same observe/forget/refit sequence from the same empty state reproduces
the same posterior (modulo float reassociation across refactorisations —
the recovery contract is 1e-5 on posterior moments, not bitwise equality
on factors).  That makes crash recovery a *log problem*:

  * :class:`Journal` appends one JSONL record per update **before** the
    state mutation runs (write-ahead: a crash mid-update loses at most the
    un-acked tail, never an acked mutation); every record carries ``t``,
    ``seq`` and ``type``, flushed per line;
  * :func:`recover` restores the latest ServeState checkpoint (the
    mutable leaves through ``repro_torch.checkpoint.CheckpointManager``;
    the manifest remembers the journal ``seq`` the checkpoint covers) and
    :func:`replay`\\ s the journal tail onto it.  No checkpoint → replay
    the whole journal from the empty state.

The records and checkpoints are the JAX package's, so a journal or a
checkpoint either package writes recovers in the other.

Replay runs with fault injection pinned *off* (``faults.use_faults(None)``)
— recovery reconstructs what was acked, it does not re-roll the dice — and
applies observes through the guarded ``observe_batch`` path with each
record's own policy, so a journal recorded under degradation (eviction,
rejected rows) degrades identically on replay.
"""
from __future__ import annotations

import json
import os
import time

from . import faults

# Journal record types and the update-layer calls they replay into.
EVENT_TYPES = ("observe", "forget", "refit", "refit_alpha")


class Journal:
    """Append-only JSONL write-ahead log of serving state updates.

    Opening an existing path resumes its sequence numbering (the recovery
    process appends to the same journal it just replayed).  ``fsync=True``
    makes each append durable against OS/machine crashes; the default
    (flush only) is durable against *process* crashes — ``os._exit``, the
    failure mode the chaos tests inject — without paying a sync per op."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self.seq = -1
        if os.path.exists(path):
            for rec in read_journal(path):
                self.seq = max(self.seq, int(rec["seq"]))
        self._fh = open(path, "a", encoding="utf-8")

    def log(self, kind: str, **payload) -> int:
        """Append one record; returns its ``seq``.  Call *before* mutating
        the state (write-ahead), as :class:`ResilientServer` does."""
        if kind not in EVENT_TYPES:
            raise ValueError(
                f"unknown journal event {kind!r}; valid: {EVENT_TYPES}"
            )
        self.seq += 1
        rec = {"t": time.time(), "seq": self.seq, "type": kind, **payload}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        return self.seq

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_journal(path: str) -> list[dict]:
    """Parse a journal file; a torn final line (crash mid-append) is
    dropped, any earlier corruption raises — silent mid-log damage would
    replay a wrong state."""
    events: list[dict] = []
    with open(path, encoding="utf-8") as fh:
        lines = fh.readlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break  # torn tail write — the op was never acked
            raise
    return events


def replay(state, events, from_seq: int = -1):
    """Fold journal ``events`` with ``seq > from_seq`` onto ``state``.

    Returns ``(state, n_replayed)``.  Observes go through the guarded
    ``observe_batch`` with each record's own overflow policy and refit
    choice, so a journal recorded under degradation degrades identically
    on replay."""
    from ..serving import update

    n = 0
    with faults.use_faults(None):
        for ev in events:
            if int(ev["seq"]) <= from_seq:
                continue
            kind = ev["type"]
            if kind == "observe":
                state = update.observe_batch(
                    state, ev["nodes"], ev["ys"],
                    on_overflow=ev.get("on_overflow", "reject"),
                    auto_refit=ev.get("auto_refit", True),
                )
            elif kind == "forget":
                state = update.forget(state, ev["slot"])
            elif kind == "refit":
                state = update.refit(
                    state, f=ev.get("f"), sigma_n2=ev.get("sigma_n2")
                )
            elif kind == "refit_alpha":
                state = update.refit_alpha(
                    state, f=ev.get("f"), sigma_n2=ev.get("sigma_n2"),
                    escalate=ev.get("escalate", True),
                )
            else:
                raise ValueError(
                    f"unknown journal event {kind!r} at seq {ev['seq']}; "
                    f"valid: {EVENT_TYPES}"
                )
            n += 1
    return state, n


def recover(example_state, journal_path: str, checkpoint_dir: str | None = None):
    """Rebuild the serving state after a crash: latest checkpoint (if any)
    + journal tail.

    ``example_state`` is the *empty* state from ``serving.init_state``
    with the same graph/hyperparameters/capacity the crashed process used —
    it gives the tree structure, devices and dtypes for the checkpoint
    restore and the fold seed when no checkpoint exists.  Returns
    ``(state, n_replayed)``.
    """
    from ..serving import update

    events = read_journal(journal_path) if os.path.exists(journal_path) else []
    state, from_seq = example_state, -1
    if checkpoint_dir is not None and os.path.isdir(checkpoint_dir):
        from ..checkpoint import CheckpointManager

        mgr = CheckpointManager(checkpoint_dir)
        if mgr.latest_step() is not None:
            packed, manifest = mgr.restore(update._pack(example_state))
            state = update._unpack(example_state, packed)
            from_seq = int(
                (manifest.get("extra") or {}).get("journal_seq", -1)
            )
    return replay(state, events, from_seq=from_seq)
