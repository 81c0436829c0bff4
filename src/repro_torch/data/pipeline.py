"""Deterministic host data pipeline with a checkpointable cursor (the port's
own copy of ``repro/data/pipeline.py``, numpy only).

Synthetic LM token streams: tokens are a seeded draw of (stream seed, step),
so any host can regenerate any step, and a restarted run resumes from the
checkpointed cursor with the exact global batch.  For the same
``(seed, step)`` the batches are the JAX package's byte for byte, the
encoder and vision stubs' inputs included."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    step: int = 0                    # checkpointable cursor
    enc_seq: int = 0                 # whisper frame stub
    n_vis_tokens: int = 0            # vision patch stub
    d_model: int = 0

    def next_batch(self) -> dict:
        """{"tokens", "labels"} int32 [B, S] (labels = tokens shifted by
        one), plus float32 ``enc_input`` [B, enc_seq, D] and ``vis_input``
        [B, n_vis_tokens, D] where the config has them."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.step]))
        toks = rng.integers(
            0, self.vocab_size, (self.global_batch, self.seq_len + 1), dtype=np.int32
        )
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.enc_seq:
            batch["enc_input"] = rng.standard_normal(
                (self.global_batch, self.enc_seq, self.d_model)
            ).astype(np.float32)
        if self.n_vis_tokens:
            batch["vis_input"] = rng.standard_normal(
                (self.global_batch, self.n_vis_tokens, self.d_model)
            ).astype(np.float32)
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def restore(self, state: dict):
        self.seed = int(state["seed"])
        self.step = int(state["step"])
