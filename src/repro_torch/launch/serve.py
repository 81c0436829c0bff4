"""Batched LM serving: prefill + decode loop with slot management (port of
``repro/launch/serve.py``).

Fixed-capacity request slots, one prefill per admitted request, batched
single-token decode steps across all live slots, greedy or temperature
sampling, per-slot stop handling — the JAX loop's static-batch rules kept:
one shared ``pos`` per decode step, equal prompt lengths per wave, and a
request stops at ``max_len - 1``.

The loop casts the matmul weights and the embedding to ``cfg.dtype`` once,
when it starts, and keeps the norm scales in float32.  The JAX model casts
the same float32 weights to ``cfg.dtype`` at every use, so the numbers are
the same; the loop just does not re-read the float32 weights on every step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..models import model
from ..models.config import ModelConfig

_NORMS = ("norm", "final_norm")


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # int32[prompt_len]
    max_new_tokens: int = 32
    temperature: float = 0.0
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


def serving_params(params: dict, cfg: ModelConfig) -> dict:
    """``params`` with every weight but the norm scales cast to cfg.dtype."""
    dtype = getattr(torch, cfg.dtype)

    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [cast(v, key) for v in tree]
        return tree if key in _NORMS else tree.to(dtype)

    return cast(params)


class ServeLoop:
    """Fixed-batch serving: admit up to ``batch`` concurrent requests.

    Runs on the device of ``params``.  Temperature sampling draws from
    ``generator`` (default: one on that device seeded with 0)."""

    def __init__(self, cfg: ModelConfig, params, batch: int, max_len: int,
                 generator: torch.Generator | None = None):
        self.cfg = cfg
        self.params = serving_params(params, cfg)
        self.device = self.params["embed"].device
        self.batch = batch
        self.max_len = max_len
        self.generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        self.cache = model.init_cache(cfg, batch, max_len, device=self.device)
        self.slots: list[Request | None] = [None] * batch
        self.pos = np.zeros(batch, dtype=np.int32)
        self.last_token = np.zeros((batch, 1), dtype=np.int32)

    # -- admission -----------------------------------------------------------
    def admit(self, req: Request) -> bool:
        """Prefill one request into a free slot; False if none free."""
        try:
            slot = self.slots.index(None)
        except ValueError:
            return False
        # Static-batch constraint: concurrent prompts share one position
        # counter, so all admitted prompts must have the same length as the
        # current wave.
        live_lens = {int(self.pos[i]) for i, r in enumerate(self.slots) if r}
        if live_lens and live_lens != {len(req.prompt)}:
            return False
        # Single-request prefill (batch-1 cache), then splice into the slot.
        tokens = torch.as_tensor(np.asarray(req.prompt)[None, :],
                                 device=self.device).long()
        logits, cache1 = model.prefill(self.params, self.cfg, tokens,
                                       max_len=self.max_len)
        model.tree_map(lambda full, one: _splice(full, one, slot),
                       self.cache, cache1)
        self.slots[slot] = req
        self.pos[slot] = len(req.prompt)
        self.last_token[slot, 0] = self._sample(logits[0], req)
        req.generated.append(int(self.last_token[slot, 0]))
        return True

    def _sample(self, logits: torch.Tensor, req: Request,
                greedy: int | None = None) -> int:
        if req.temperature <= 0:
            # argmax takes the first index on ties, as jnp.argmax does.
            return int(torch.argmax(logits)) if greedy is None else greedy
        probs = torch.softmax(logits.to(torch.float32) / req.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self.generator))

    # -- decode --------------------------------------------------------------
    def step(self) -> int:
        """One batched decode step across live slots; returns #live."""
        live = [i for i, r in enumerate(self.slots) if r is not None and not r.done]
        if not live:
            return 0
        # All slots share one position counter per step; decode uses the max
        # and per-slot validity is enforced by each slot's own cache content.
        pos = int(max(self.pos[i] for i in live))
        token = torch.as_tensor(self.last_token, device=self.device).long()
        logits, self.cache = model.decode_step(self.params, self.cache,
                                               self.cfg, token, pos)
        greedy = torch.argmax(logits[:, 0], dim=-1).tolist()   # one read
        for i in live:
            req = self.slots[i]
            tok = self._sample(logits[i, 0], req, greedy[i])
            req.generated.append(tok)
            self.last_token[i, 0] = tok
            self.pos[i] += 1
            if len(req.generated) >= req.max_new_tokens or self.pos[i] >= self.max_len - 1:
                req.done = True
                self.slots[i] = None
        return len(live)

    def run(self, requests: list[Request], progress: Callable | None = None):
        pending = list(requests)
        while pending or any(s is not None for s in self.slots):
            while pending and self.admit(pending[0]):
                pending.pop(0)
            n = self.step()
            if progress:
                progress(n, len(pending))
        return requests


def _splice(full: torch.Tensor, one: torch.Tensor, slot: int) -> torch.Tensor:
    """Insert a batch-1 cache entry into slot ``slot`` of a batched cache.

    Cache leaves have a leading stacked [repeat] axis then batch.  The slot
    is written in place: the loop is the only owner of its cache."""
    full[:, slot:slot + 1] = one.to(full.dtype)
    return full
