"""The LM scaffold's model: init, forward, and the serving path with KV
caches (port of ``repro/models/model.py`` for stages of ``attn`` layers with
dense MLPs).

Parameters mirror the config's stage structure: ``params['stages'][si]`` is
a dict whose leaves carry a leading ``[repeat]`` axis, the JAX pytree's
layout, so that the JAX package's parameters carry across leaf for leaf
(``interop.model_params_from_numpy``).  The JAX ``lax.scan`` over the repeat
axis is a Python loop here.  Caches follow the same layout; ``decode_step``
writes into its cache in place and returns it.

Public entry points:
  init_params(cfg, seed, device)           — random init from a seed
  forward(params, cfg, tokens)             — logits [B, S, V] f32 (+ aux 0)
  init_cache / prefill / decode_step       — serving path with KV caches

Not ported yet, and raising NotImplementedError (ROADMAP Queue 1 #9): MLA,
mamba, shared attention, cross-attention, MoE, the encoder, ``loss_fn`` and
remat (the training slice).
"""
from __future__ import annotations

import torch

from .. import device as _device
from . import attention
from .config import LayerSpec, ModelConfig
from .layers import KeyGen, dense_init, embed_init, rms_norm, swiglu


def _check_config(cfg: ModelConfig) -> None:
    for _, pattern in cfg.stages:
        for spec in pattern:
            if spec.kind != "attn":
                raise NotImplementedError(
                    f"layer kind {spec.kind!r} {attention.NOT_PORTED}")
            if spec.moe:
                raise NotImplementedError(f"MoE layers {attention.NOT_PORTED}")
    if cfg.n_enc_layers or cfg.n_vis_tokens:
        raise NotImplementedError(
            f"the encoder and vision stubs {attention.NOT_PORTED}")


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
    p = {"attn": attention.init_attn(kg, cfg)}
    if spec.has_mlp:
        p["mlp"] = _init_mlp(kg, cfg)
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


def _stack(trees: list):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Float32 parameters from ``seed``, with the JAX init's distributions
    (not its numbers), on ``device`` (default: the card)."""
    _check_config(cfg)
    dev = _device.resolve(device)
    kg = KeyGen(seed, dev)
    params: dict = {"embed": embed_init(kg(), cfg.vocab_size, cfg.d_model)}
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(kg(), cfg.vocab_size, cfg.d_model)
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev)
    stages = []
    for repeat, pattern in cfg.stages:
        reps = [{f"L{pi}": _init_layer(kg, cfg, spec) for pi, spec in enumerate(pattern)}
                for _ in range(repeat)]
        stages.append(_stack(reps))
        del reps
    params["stages"] = stages
    return params


# ---------------------------------------------------------------------------
# Forward (scoring).
# ---------------------------------------------------------------------------

def _mlp_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    xn = rms_norm(x, p["norm"])
    return x + swiglu(xn, p["gate"], p["up"], p["down"])


def _rep(stage_params, r: int):
    """Repeat ``r`` of a stacked stage (views, no copy)."""
    return tree_map(lambda a: a[r], stage_params)


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    dtype = getattr(torch, cfg.dtype)
    x = params["embed"][tokens].to(dtype)
    # The scale rounds to the activation dtype first (√2560 → 50.5 in bf16).
    return x * torch.tensor(cfg.d_model**0.5, dtype=dtype, device=x.device)


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    unembed = params.get("unembed", params["embed"])
    logits = (x @ unembed.to(x.dtype).T).to(torch.float32)
    if cfg.final_logit_softcap:
        logits = cfg.final_logit_softcap * torch.tanh(logits / cfg.final_logit_softcap)
    return logits


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor | None = None):
    """Returns (logits [B,S,V] f32, aux loss 0: no MoE here)."""
    _check_config(cfg)
    x = _embed(params, cfg, tokens)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=x.device)
    for si, (repeat, pattern) in enumerate(cfg.stages):
        for r in range(repeat):
            rep = _rep(params["stages"][si], r)
            for pi, spec in enumerate(pattern):
                p = rep[f"L{pi}"]
                x = attention.attn_forward(p["attn"], x, cfg, spec, positions)
                if spec.has_mlp:
                    x = _mlp_forward(p["mlp"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, cfg, x), aux


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode.
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """Zeroed decode cache mirroring the stage structure."""
    _check_config(cfg)
    dev = _device.resolve(device)
    stages = []
    for repeat, pattern in cfg.stages:
        one = {f"L{pi}": attention.attn_init_cache(cfg, spec, batch, max_len, dev)
               for pi, spec in enumerate(pattern)}
        stages.append(tree_map(lambda a: a.expand(repeat, *a.shape).contiguous(), one))
    return {"stages": stages}


def decode_step(params: dict, cache: dict, cfg: ModelConfig,
                token: torch.Tensor, pos: int):
    """One-token decode: returns (logits [B,1,V], cache).

    ``token`` [B, 1]; ``pos`` the position being generated (one for all
    rows).  The new K/V are written into ``cache`` in place."""
    _check_config(cfg)
    pos = int(pos)
    x = _embed(params, cfg, token)
    for si, (repeat, pattern) in enumerate(cfg.stages):
        for r in range(repeat):
            rep = _rep(params["stages"][si], r)
            rep_cache = _rep(cache["stages"][si], r)
            for pi, spec in enumerate(pattern):
                p = rep[f"L{pi}"]
                x, _ = attention.attn_decode(p["attn"], x, rep_cache[f"L{pi}"],
                                             cfg, spec, pos)
                if spec.has_mlp:
                    x = _mlp_forward(p["mlp"], x)
    return _logits(params, cfg, x), cache


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, max_len: int):
    """Forward over a prompt, producing (last-token logits [B, V], cache)."""
    _check_config(cfg)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    stages = []
    for si, (repeat, pattern) in enumerate(cfg.stages):
        reps = []
        for r in range(repeat):
            rep = _rep(params["stages"][si], r)
            caches = {}
            for pi, spec in enumerate(pattern):
                p = rep[f"L{pi}"]
                x, caches[f"L{pi}"] = attention.attn_prefill(
                    p["attn"], x, cfg, spec, positions, max_len)
                if spec.has_mlp:
                    x = _mlp_forward(p["mlp"], x)
            reps.append(caches)
        stages.append(_stack(reps))
    return _logits(params, cfg, x[:, -1]), {"stages": stages}
