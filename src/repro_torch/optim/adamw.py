"""AdamW and schedules (port of ``repro/optim/adamw.py``).

A plain port, not ``torch.optim.AdamW``: the hyperparameter fit's parity
with the JAX package depends on the same update order and epsilon placement
(ε added to √v̂, bias corrections computed in float32).  Parameters, moments
and gradients are nested dicts (or lists/tuples) of tensors.  The step is
computed in place by ``update_`` (the gradients, moments and parameters it
is given are overwritten), so that a large model's step holds one copy of
each, as JAX's donated buffers do; ``update`` is the functional form, the
same arithmetic on copies.
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
        """The functional update: :meth:`update_` applied to copies, so the
        tensors given are left as they were."""
        def copy(tree):
            return tree_map(lambda x: x.detach().clone(), tree)

        return self.update_(copy(grads), AdamState(state.step, copy(state.mu),
                                                   copy(state.nu)), copy(params))

    def update_(self, grads: Any, state: AdamState, params: Any):
        """The update in place: the clipped gradients, then μ, ν and the
        parameters overwrite ``grads``, ``state.mu``, ``state.nu`` and
        ``params``, one leaf at a time.  Returns (params, AdamState) holding
        those tensors."""
        step = state.step + 1
        g_leaves = tree_leaves(grads)
        if self.grad_clip is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            for g in g_leaves:
                g.mul_(scale)
        step_f = torch.tensor(float(step), dtype=torch.float32)
        lr = self.lr(step_f) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        # float32 powers, as jnp computes b ** step.astype(float32).
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), step_f)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), step_f)

        def upd_(p, m, v, g):   # leaves paired by key, as tree_map does
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            delta = (m / c1.to(m.device)) / (torch.sqrt(v / c2.to(v.device)) + self.eps)
            if self.weight_decay and p.dim() >= 2:  # decay matrices only
                delta = delta + self.weight_decay * p
            lr_p = lr.to(p.device) if isinstance(lr, torch.Tensor) else lr
            p.sub_(lr_p * delta)

        with torch.no_grad():
            tree_map(upd_, params, state.mu, state.nu, grads)
        return params, AdamState(step=step, mu=state.mu, nu=state.nu)


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
