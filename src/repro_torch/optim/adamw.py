"""AdamW and schedules (port of ``repro/optim/adamw.py``).

A plain port, not ``torch.optim.AdamW``: the hyperparameter fit's parity
with the JAX package depends on the same update order and epsilon placement
(ε added to √v̂, bias corrections computed in float32).  Parameters, moments
and gradients are nested dicts (or lists/tuples) of tensors; every update is
functional and returns new tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over nested dicts/lists/tuples of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The tensor leaves of ``tree`` in a fixed (insertion) order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


class AdamState(NamedTuple):
    step: int
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float | None = None

    def init(self, params: Any) -> AdamState:
        return AdamState(
            step=0,
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
        )

    def update(self, grads: Any, state: AdamState, params: Any):
        step = state.step + 1
        if self.grad_clip is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        step_f = torch.tensor(float(step), dtype=torch.float32)
        lr = self.lr(step_f) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        # float32 powers, as jnp computes b ** step.astype(float32).
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), step_f)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), step_f)

        def upd(p, m, v):
            mhat = m / c1.to(m.device)
            vhat = v / c2.to(v.device)
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay and p.dim() >= 2:  # decay matrices only
                delta = delta + self.weight_decay * p
            lr_p = lr.to(p.device) if isinstance(lr, torch.Tensor) else lr
            return (p - lr_p * delta).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, AdamState(step=step, mu=mu, nu=nu)


def global_norm(tree: Any) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in leaves))


def cosine_schedule(peak_lr: float, warmup: int, total: int) -> Callable:
    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return fn
