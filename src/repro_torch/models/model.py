"""The LM scaffold's model: init, forward, loss, remat and the serving path
with KV/SSM caches, for every layer kind of the ten configs (port of
``repro/models/model.py``).

Parameters mirror the config's stage structure: ``params['stages'][si]`` is
a dict whose leaves carry a leading ``[repeat]`` axis, the JAX pytree's
layout, so that the JAX package's parameters carry across leaf for leaf
(``interop.model_params_from_numpy``) and AdamW decays the same leaves
(``ndim >= 2``: the stacked norms are decayed, ``final_norm`` is not).  The
JAX ``lax.scan`` over the repeat axis is a Python loop over the repeats'
views (``unbind``: one stack in the backward pass).  Shared blocks (zamba2)
are stored once in ``params['shared']`` and applied at every
``shared_attn`` slot; whisper's encoder lives in ``params['encoder']``.
Caches follow the same layout; ``decode_step`` writes into its cache in
place and returns it.

Remat (``cfg.remat``) wraps each repeat's body in
``torch.utils.checkpoint``: ``"full"`` recomputes everything in the
backward pass, ``"dots"`` saves the outputs of matmuls with no batch dims
(``aten.mm``/``addmm``, what ``checkpoint_dots_with_no_batch_dims``
saves) and recomputes the rest, ``"none"`` checkpoints nothing.  Remat
changes memory, never numbers.

Public entry points:
  init_params(cfg, seed, device)           — random init from a seed
  forward(params, cfg, tokens, ...)        — logits [B, S, V] f32 + MoE aux
  loss_fn(params, cfg, batch)              — next-token CE + z-loss + aux
  init_cache / prefill / decode_step       — serving path with caches

Sharded: every entry point also runs with DTensor parameters, caches and
inputs (``launch/sharding.py``'s placements; the train step and the dry run
trace it so).  DTensor carries most ops itself; the exceptions run shard
by shard (the kernels' wrappers, decode attention, the prefill caches
through ``layers.on_shards``, MLA's attention, the MoE expert path, the
SSD scan), the residual stream keeps a batch-only layout between
sublayers (``layers.residual``), and ``cfg.sp_attn`` constrains
attention's activations as the JAX package does.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from .. import device as _device
from ..kernels import build
from . import attention, mla, moe, ssm
from .config import LayerSpec, ModelConfig
from .layers import KeyGen, dense_init, embed_init, residual, rms_norm, swiglu


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------

def _init_mlp(kg: KeyGen, cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm": torch.zeros((d,), dtype=torch.float32, device=kg.device),
        "gate": dense_init(kg(), (d, f)),
        "up": dense_init(kg(), (d, f)),
        "down": dense_init(kg(), (f, d), scale=f**-0.5),
    }


def _init_layer(kg: KeyGen, cfg: ModelConfig, spec: LayerSpec) -> dict:
    p: dict = {}
    if spec.kind in ("attn", "cross_attn"):
        p["attn"] = attention.init_attn(kg, cfg)
    elif spec.kind == "mla":
        p["mla"] = mla.init_mla(kg, cfg)
    elif spec.kind == "mamba":
        p["mamba"] = ssm.init_mamba(kg, cfg)
    # shared_attn: its parameters live in params['shared'].
    if spec.has_mlp and spec.kind not in ("mamba", "shared_attn"):
        p["moe" if spec.moe else "mlp"] = (
            moe.init_moe(kg, cfg) if spec.moe else _init_mlp(kg, cfg))
    return p


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts/lists of tensors."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_with_leaves(tree, leaves):
    """``tree`` with its leaves replaced, in :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _stack(trees: list):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _init_stage(kg: KeyGen, cfg: ModelConfig, repeat: int, pattern) -> dict:
    reps = [{f"L{pi}": _init_layer(kg, cfg, spec) for pi, spec in enumerate(pattern)}
            for _ in range(repeat)]
    return _stack(reps)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Float32 parameters from ``seed``, with the JAX init's distributions
    (not its numbers), on ``device`` (default: the card)."""
    dev = _device.resolve(device)
    kg = KeyGen(seed, dev)
    params: dict = {"embed": embed_init(kg(), cfg.vocab_size, cfg.d_model)}
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(kg(), cfg.vocab_size, cfg.d_model)
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev)
    params["stages"] = [_init_stage(kg, cfg, repeat, pattern)
                        for repeat, pattern in cfg.stages]
    if any(s.kind == "shared_attn" for _, p in cfg.stages for s in p):
        params["shared"] = {"attn": attention.init_attn(kg, cfg),
                            "mlp": _init_mlp(kg, cfg)}
    if cfg.n_enc_layers:
        enc = (LayerSpec(kind="attn", causal=False),) * cfg.enc_pattern_mult
        params["encoder"] = {
            "stages": [_init_stage(kg, cfg, cfg.n_enc_layers, enc)],
            "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
        }
    return params


# ---------------------------------------------------------------------------
# Forward (train / scoring).
# ---------------------------------------------------------------------------

def _mlp_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    xn = rms_norm(x, p["norm"])
    return x + swiglu(xn, p["gate"], p["up"], p["down"])


def _apply_layer(spec: LayerSpec, p: dict, x, cfg, positions, shared, enc_out):
    """One layer forward; returns (x, aux loss or None)."""
    if spec.kind == "attn":
        x = attention.attn_forward(p["attn"], x, cfg, spec, positions)
    elif spec.kind == "cross_attn":
        x = attention.attn_forward(p["attn"], x, cfg, spec, positions, enc_out=enc_out)
    elif spec.kind == "mla":
        x = mla.mla_forward(p["mla"], x, cfg, positions)
    elif spec.kind == "mamba":
        return ssm.mamba_forward(p["mamba"], x, cfg), None
    elif spec.kind == "shared_attn":
        x = attention.attn_forward(shared["attn"], x, cfg, spec, positions)
        return _mlp_forward(shared["mlp"], residual(x)), None
    else:
        raise ValueError(spec.kind)
    return _ffn(spec, p, x, cfg)


def _ffn(spec: LayerSpec, p: dict, x, cfg):
    """The layer's MoE or MLP tail, if it has one: (x, aux loss or None),
    on the residual stream's layout."""
    x = residual(x)
    if spec.has_mlp and spec.moe:
        return moe.moe_forward(p["moe"], x, cfg)
    if spec.has_mlp:
        return _mlp_forward(p["mlp"], x), None
    return x, None


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matmuls with no batch dims, recompute the rest."""
    del ctx, args, kwargs
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, cfg: ModelConfig):
    if not torch.is_grad_enabled() or cfg.remat not in ("full", "dots"):
        return fn
    kw: dict = {"use_reentrant": False}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(_ckpt.checkpoint, fn, **kw)


def unshard(tree):
    """FSDP at the point of use: every DTensor leaf split over the ``data``
    mesh dim gathered whole along it (the redistribute's backward
    reduce-scatters its gradient back to the split), as the layer that uses
    it starts; inside a remat body the gather is redone in the backward.
    Without it DTensor may keep the weight split and gather the activations'
    batch instead, every rank then computing the whole batch.  Other trees
    pass through."""
    leaves = tree_leaves(tree) if tree is not None else []
    if not leaves or not build.is_dtensor(leaves[0]):
        return tree
    from torch.distributed.tensor import Replicate

    def gather(t):
        if not build.is_dtensor(t) or "data" not in (t.device_mesh.mesh_dim_names or ()):
            return t
        i = t.device_mesh.mesh_dim_names.index("data")
        if not t.placements[i].is_shard():
            return t
        pl = list(t.placements)
        pl[i] = Replicate()
        return t.redistribute(t.device_mesh, tuple(pl))

    return tree_map(gather, tree)


def _reps(stage, repeat: int) -> list:
    """The ``repeat`` per-repeat trees of a stacked stage (parameters or a
    cache): views of one ``unbind`` per leaf, whose backward is one stack
    and which take a cache's in-place writes."""
    cols = [a.unbind(0) for a in tree_leaves(stage)]
    return [tree_with_leaves(stage, [c[r] for c in cols]) for r in range(repeat)]


def _stage_forward(stage_params, pattern, repeat, x, cfg, positions, shared, enc_out):
    """A stage's repeats in order, each one remat-wrapped body; returns
    (x, the stage's aux loss)."""
    def body(h, aux, rep, shared, enc_out):
        rep, shared = unshard(rep), unshard(shared)
        for pi, spec in enumerate(pattern):
            h, a = _apply_layer(spec, rep[f"L{pi}"], h, cfg, positions, shared, enc_out)
            h = residual(h)
            if a is not None:   # the JAX carry adds an exact 0 for the others
                aux = aux + a
        return h, aux

    body = _remat_wrap(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for rep in _reps(stage_params, repeat):
        x, aux = body(x, aux, rep, shared, enc_out)
    return x, aux


def _encode(params, cfg: ModelConfig, enc_input):
    """Whisper-style encoder over precomputed frame embeddings (stub
    frontend): non-causal attention layers, then a final norm."""
    x = residual(enc_input.to(getattr(torch, cfg.dtype)))
    positions = torch.arange(x.shape[1], device=x.device)
    pattern = (LayerSpec(kind="attn", causal=False),) * cfg.enc_pattern_mult
    x, _ = _stage_forward(params["encoder"]["stages"][0], pattern, cfg.n_enc_layers,
                          x, cfg, positions, None, None)
    return rms_norm(x, params["encoder"]["final_norm"])


def _enc_out(params, cfg: ModelConfig, enc_input, vis_input):
    """The cross-attention memory: the encoder's output, or the vision
    stub's patch embeddings as they are."""
    enc_out = None
    if cfg.n_enc_layers and enc_input is not None:
        enc_out = _encode(params, cfg, enc_input)
    if cfg.n_vis_tokens and vis_input is not None:
        enc_out = residual(vis_input.to(getattr(torch, cfg.dtype)))
    return enc_out


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    dtype = getattr(torch, cfg.dtype)
    # F.embedding, not indexing: DTensor looks up a vocab-sharded table
    # shard by shard only through the embedding op.
    x = residual(F.embedding(tokens.long(), unshard(params["embed"]))).to(dtype)
    # The scale rounds to the activation dtype first (√2560 → 50.5 in bf16).
    return x * torch.tensor(cfg.d_model**0.5, dtype=dtype, device=x.device)


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    unembed = unshard(params.get("unembed", params["embed"]))
    logits = (x @ unembed.to(x.dtype).T).to(torch.float32)
    if cfg.final_logit_softcap:
        logits = cfg.final_logit_softcap * torch.tanh(logits / cfg.final_logit_softcap)
    return logits


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            enc_input: torch.Tensor | None = None,   # [B, enc_seq, D] (whisper stub)
            vis_input: torch.Tensor | None = None,   # [B, n_vis, D] (vision stub)
            positions: torch.Tensor | None = None):
    """Returns (logits [B,S,V] f32, aux MoE loss f32 scalar)."""
    x = _embed(params, cfg, tokens)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=x.device)
    enc_out = _enc_out(params, cfg, enc_input, vis_input)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, (repeat, pattern) in enumerate(cfg.stages):
        x, a = _stage_forward(params["stages"][si], pattern, repeat, x, cfg,
                              positions, params.get("shared"), enc_out)
        aux = aux + a
    return _logits(params, cfg, x), aux


def loss_fn(params: dict, cfg: ModelConfig, batch: dict):
    """Next-token CE + z-loss + MoE load-balancing aux: (total, {"ce",
    "zloss", "moe_aux"}).  ``batch`` holds ``tokens`` and ``labels`` [B, S]
    and, where the config has them, ``enc_input`` / ``vis_input``."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          enc_input=batch.get("enc_input"),
                          vis_input=batch.get("vis_input"))
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])
    if build.is_dtensor(picked):
        # Over a vocab-sharded table the pick is a masked partial sum,
        # whose mask DTensor cannot carry through the reshape below.
        from torch.distributed.tensor import Replicate

        picked = picked.redistribute(picked.device_mesh, tuple(
            Replicate() if p.is_partial() else p for p in picked.placements))
    logp = picked[..., 0] - logz
    ce = -torch.mean(logp)
    zloss = 1e-4 * torch.mean(logz**2)
    total = ce + zloss + 0.01 * aux
    return total, {"ce": ce, "zloss": zloss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode.
# ---------------------------------------------------------------------------

def _layer_cache(cfg, spec, batch, max_len, device):
    if spec.kind in ("attn", "cross_attn", "shared_attn"):
        return attention.attn_init_cache(cfg, spec, batch, max_len, device)
    if spec.kind == "mla":
        return mla.mla_init_cache(cfg, batch, max_len, device)
    if spec.kind == "mamba":
        return ssm.mamba_init_cache(cfg, batch, device)
    raise ValueError(spec.kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """Zeroed decode cache mirroring the stage structure."""
    dev = _device.resolve(device)
    stages = []
    for repeat, pattern in cfg.stages:
        one = {f"L{pi}": _layer_cache(cfg, spec, batch, max_len, dev)
               for pi, spec in enumerate(pattern)}
        stages.append(tree_map(lambda a: a.expand(repeat, *a.shape).contiguous(), one))
    return {"stages": stages}


def _apply_layer_decode(spec, p, c, x, cfg, pos, shared):
    if spec.kind in ("attn", "cross_attn"):
        x, c = attention.attn_decode(p["attn"], x, c, cfg, spec, pos)
    elif spec.kind == "mla":
        x, c = mla.mla_decode(p["mla"], x, c, cfg, pos)
    elif spec.kind == "mamba":
        return ssm.mamba_decode(p["mamba"], x, c, cfg)
    elif spec.kind == "shared_attn":
        x, c = attention.attn_decode(shared["attn"], x, c, cfg, spec, pos)
        return _mlp_forward(shared["mlp"], residual(x)), c
    else:
        raise ValueError(spec.kind)
    return _ffn(spec, p, x, cfg)[0], c


def decode_step(params: dict, cache: dict, cfg: ModelConfig,
                token: torch.Tensor, pos: int):
    """One-token decode: returns (logits [B,1,V], cache).

    ``token`` [B, 1]; ``pos`` the position being generated (one for all
    rows).  Each layer writes its new state into ``cache`` in place."""
    pos = int(pos)
    x = _embed(params, cfg, token)
    shared = params.get("shared")
    for si, (repeat, pattern) in enumerate(cfg.stages):
        for rep, rep_cache in zip(map(unshard, _reps(params["stages"][si], repeat)),
                                  _reps(cache["stages"][si], repeat)):
            for pi, spec in enumerate(pattern):
                x, _ = _apply_layer_decode(spec, rep[f"L{pi}"], rep_cache[f"L{pi}"],
                                           x, cfg, pos, shared)
                x = residual(x)
    return _logits(params, cfg, x), cache


def _apply_layer_prefill(spec, p, x, cfg, positions, max_len, shared, enc_out):
    if spec.kind in ("attn", "cross_attn"):
        x, c = attention.attn_prefill(
            p["attn"], x, cfg, spec, positions, max_len,
            enc_out=enc_out if spec.kind == "cross_attn" else None)
    elif spec.kind == "mla":
        x, c = mla.mla_prefill(p["mla"], x, cfg, positions, max_len)
    elif spec.kind == "mamba":
        return ssm.mamba_forward(p["mamba"], x, cfg, return_state=True)
    elif spec.kind == "shared_attn":
        x, c = attention.attn_prefill(shared["attn"], x, cfg, spec, positions, max_len)
        return _mlp_forward(shared["mlp"], residual(x)), c
    else:
        raise ValueError(spec.kind)
    return _ffn(spec, p, x, cfg)[0], c


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, max_len: int,
            enc_input: torch.Tensor | None = None,
            vis_input: torch.Tensor | None = None):
    """Forward over a prompt, producing (last-token logits [B, V], cache)."""
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    shared = params.get("shared")
    enc_out = _enc_out(params, cfg, enc_input, vis_input)
    stages = []
    for si, (repeat, pattern) in enumerate(cfg.stages):
        reps = []
        for rep in map(unshard, _reps(params["stages"][si], repeat)):
            caches = {}
            for pi, spec in enumerate(pattern):
                x, caches[f"L{pi}"] = _apply_layer_prefill(
                    spec, rep[f"L{pi}"], x, cfg, positions, max_len, shared, enc_out)
                x = residual(x)
            reps.append(caches)
        stages.append(_stack(reps))
    return _logits(params, cfg, x[:, -1]), {"stages": stages}
