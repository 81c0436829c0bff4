"""Training launcher: the train step and the fault-tolerant loop (port of
``repro/launch/train.py``).

``make_train_step`` builds the (state, batch) → (state, metrics) function,
with gradients from ``torch.autograd`` and optional gradient accumulation
over microbatches: float32 gradients summed over contiguous splits of the
batch, in order, then divided by their number, as the JAX ``lax.scan``
does (whose metrics quirk is kept: ``ce`` is the mean total loss and
``zloss`` = ``moe_aux`` = 0).  The step updates the state it is given in
place (``AdamW.update_``; ``AdamW.update`` is the same arithmetic on
copies), as JAX's donated buffers would, so a large model holds one copy of its
parameters, gradients and moments: the caller keeps no use of the old
state (clone it first to step twice from one state).

``train_loop`` is the end-to-end driver of ``examples/train_lm.py``: resume
from the newest checkpoint (the JAX package's format: a checkpoint either
package writes resumes in the other), the data stream's cursor restored,
an asynchronous checkpoint every ``ckpt_every`` steps and at the last one.
Kill it at any step and rerun it: it continues where the checkpoint left
off.  The train state's leaves stay float32 or integer (numpy, and so the
checkpoint format, has no bfloat16); activations follow ``cfg.dtype``.

Sharded: the step takes a state whose leaves are DTensors (params placed
by ``sharding.param_shardings``, μ/ν by ``opt_shardings``) and a batch
placed by ``batch_spec``; DTensor then inserts the FSDP gathers, gradient
reductions and ZeRO-1 slices, and the step runs under ``sharding.spmd``
(plain tensors the model makes count as replicated).  The caller registers
the activation mesh (``sharding.set_activation_mesh``) for ``cfg.sp_attn``."""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .. import device as _device
from ..checkpoint import CheckpointManager
from ..data import TokenStream
from ..models import model
from ..models.config import ModelConfig
from ..optim.adamw import AdamState, AdamW, global_norm
from .sharding import spmd


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamState
    step: int


def init_state(cfg: ModelConfig, seed: int, opt: AdamW, device=None) -> TrainState:
    params = model.init_params(cfg, seed, device)
    return TrainState(params=params, opt_state=opt.init(params), step=0)


def batch_to(batch: dict, device) -> dict:
    """A host batch (numpy arrays) as tensors on ``device``, dtypes kept
    (the model indexes with the token ids as int64 itself)."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


def loss_and_grads(params, cfg: ModelConfig, batch: dict):
    """(loss, metrics, grads) with gradients of every parameter (zeros for a
    parameter that the batch does not reach, e.g. an expert with no
    token)."""
    leaves = model.tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = model.loss_fn(model.tree_with_leaves(params, live), cfg, batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            model.tree_with_leaves(params, grads))


def make_train_step(cfg: ModelConfig, opt: AdamW, microbatches: int = 1):
    def train_step(state: TrainState, batch: dict):
        with spmd(state.params):
            return _step(state, batch)

    def _step(state: TrainState, batch: dict):
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(state.params, cfg, batch)
        else:
            # Gradient accumulation over microbatch slices, f32 accumulators.
            def split(x):
                b = x.shape[0]
                return x.reshape(microbatches, b // microbatches, *x.shape[1:])

            micro = {k: split(v) for k, v in batch.items()}
            grads = model.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                state.params)
            g_leaves = model.tree_leaves(grads)
            loss = 0.0
            for i in range(microbatches):
                mb_loss, _, g = loss_and_grads(
                    state.params, cfg, {k: v[i] for k, v in micro.items()})
                for acc, gi in zip(g_leaves, model.tree_leaves(g)):
                    acc.add_(gi.to(torch.float32))
                loss = loss + mb_loss
                del g
            for acc in g_leaves:
                acc.div_(microbatches)
            loss = loss / microbatches
            zero = torch.zeros((), dtype=torch.float32, device=loss.device)
            metrics = {"ce": loss, "zloss": zero, "moe_aux": zero}

        gnorm = global_norm(grads)
        new_params, new_opt = opt.update_(grads, state.opt_state, state.params)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def train_loop(
    cfg: ModelConfig,
    steps: int,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    lr: float = 3e-4,
    global_batch: int = 8,
    seq_len: int = 64,
    seed: int = 0,
    microbatches: int = 1,
    log_every: int = 10,
    device=None,
) -> tuple[TrainState, list[dict]]:
    """Single-host end-to-end training driver, on ``device`` (default: the
    card)."""
    dev = _device.resolve(device)
    opt = AdamW(lr=lr, weight_decay=0.01, grad_clip=1.0)
    state = init_state(cfg, seed, opt, dev)
    stream = TokenStream(
        vocab_size=cfg.vocab_size, global_batch=global_batch, seq_len=seq_len,
        seed=seed, enc_seq=cfg.enc_seq, n_vis_tokens=cfg.n_vis_tokens,
        d_model=cfg.d_model,
    )
    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if manager and manager.latest_step() is not None:
        state, manifest = manager.restore(state)
        stream.restore(manifest["extra"]["data"])
        start = int(manifest["step"])

    step_fn = make_train_step(cfg, opt, microbatches)
    history = []
    for i in range(start, steps):
        state, metrics = step_fn(state, batch_to(stream.next_batch(), dev))
        if i % log_every == 0 or i == steps - 1:
            history.append({"step": i, "loss": float(metrics["loss"])})
        if manager and ((i + 1) % ckpt_every == 0 or i == steps - 1):
            # The leaves are copied to the host here, before the next step
            # updates them in place.
            manager.save(int(state.step), state, blocking=False,
                         extra={"data": stream.state()})
    if manager:
        manager.wait()
    return state, history
