"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434; port of
``repro/models/mla.py``).

KV is compressed into a rank-``kv_lora_rank`` latent c_kv plus one shared
RoPE key per position, so the decode cache is O(S·(rk + rd)) instead of
O(S·H·2·hd).

Two decode paths (``cfg.mla_absorb``):
  * naive  — up-project the whole cached latent to per-head K/V each step;
  * absorb — fold W_uk into the query and apply W_uv after the weights, so
             attention runs in the latent space.

Full-sequence attention is plain tensor code with a float32 softmax, as in
the JAX package: K's head dim (hd + rd = 192 at full width) differs from
V's (hd = 128), which the shared flash kernel does not take.  Its norms go
through the rmsnorm kernel (``q_norm`` over q_lora_rank, ``kv_norm`` over
kv_lora_rank).  :func:`mla_decode` writes the new latent into the cache in
place and returns it.  ``cfg.sp_attn`` constrains the full-sequence
block's activations to head parallelism, as in the JAX package."""
from __future__ import annotations

import torch

from ..kernels import build
from ..launch.sharding import constrain
from .attention import _out_proj, _proj
from .config import ModelConfig
from .layers import KeyGen, dense_init, on_shards, rms_norm, rope


def init_mla(kg: KeyGen, cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    hd = cfg.resolved_head_dim
    rk, rq, rd = cfg.kv_lora_rank, cfg.q_lora_rank, cfg.rope_head_dim
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=kg.device)  # noqa: E731
    return {
        "norm": zeros(d),
        "wq_a": dense_init(kg(), (d, rq)),
        "q_norm": zeros(rq),
        "wq_b": dense_init(kg(), (rq, h, hd + rd)),
        "wkv_a": dense_init(kg(), (d, rk + rd)),
        "kv_norm": zeros(rk),
        "wk_b": dense_init(kg(), (rk, h, hd)),
        "wv_b": dense_init(kg(), (rk, h, hd)),
        "wo": dense_init(kg(), (h, hd, d), scale=(h * hd) ** -0.5),
    }


def _scale(cfg: ModelConfig, device) -> torch.Tensor:
    # 1/√(hd + rd) in float32, as jnp computes it.
    n = cfg.resolved_head_dim + cfg.rope_head_dim
    return 1.0 / torch.sqrt(torch.tensor(float(n), dtype=torch.float32, device=device))


def _queries(p, xn, positions, cfg):
    """q_nope [B,H,S,hd], q_rope [B,H,S,rd]."""
    hd = cfg.resolved_head_dim
    qa = rms_norm(xn @ p["wq_a"].to(xn.dtype), p["q_norm"])
    q = _proj(qa, p["wq_b"])
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _latents(p, xn, positions, cfg):
    """c_kv [B,S,rk] (normed), k_rope [B,S,rd] (roped, shared across heads)."""
    rk = cfg.kv_lora_rank
    kv = xn @ p["wkv_a"].to(xn.dtype)
    c_kv = rms_norm(kv[..., :rk], p["kv_norm"])
    k_rope = rope(kv[..., rk:], positions, cfg.rope_theta)
    return c_kv, k_rope


def by_heads(fn, *heads, batch=(), weights=()):
    """``fn(*heads, *batch, *weights)`` — on each rank's local shards when
    the first of ``heads`` is a DTensor.  ``heads`` are [B, H, ...] tensors,
    split as the first one is over its batch and heads (anything else of it
    replicated); ``batch`` are [B, ...] tensors shared by the heads, split
    over the batch only; ``weights`` are [·, H, ...] and split over the
    heads only.  The output is placed as ``heads``; a shared input's
    gradient is a partial sum over the mesh dims that split the heads.
    (DTensor's einsum flattens (batch, heads), which it does only when no
    dim but the first is split.)"""
    lead = heads[0]
    if not build.is_dtensor(lead):
        return fn(*heads, *batch, *weights)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = lead.device_mesh
    hp = tuple(p if p.is_shard(0) or p.is_shard(1) else Replicate()
               for p in lead.placements)
    bp = tuple(p if p.is_shard(0) else Replicate() for p in hp)
    wp = tuple(Shard(1) if p.is_shard(1) else Replicate() for p in hp)
    pls = [hp] * len(heads) + [bp] * len(batch) + [wp] * len(weights)
    args = [t.redistribute(mesh, pl) for t, pl in zip((*heads, *batch, *weights), pls)]
    run = local_map(fn, out_placements=(hp,), device_mesh=mesh,
                    in_grad_placements=tuple(build.grad_placements(pl, hp) for pl in pls))
    return run(*args)


def _softmax(s: torch.Tensor, valid: torch.Tensor, dtype) -> torch.Tensor:
    return torch.softmax(s.masked_fill(~valid, -1e30), dim=-1).to(dtype)


def mla_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """Full-sequence MLA (train / prefill). x: [B,S,D]."""
    xn = rms_norm(x, p["norm"])
    dt = xn.dtype
    q_nope, q_rope = _queries(p, xn, positions, cfg)
    c_kv, k_rope = _latents(p, xn, positions, cfg)
    k_nope = _proj(c_kv, p["wk_b"])
    v = _proj(c_kv, p["wv_b"])
    if cfg.sp_attn:
        # Megatron-style head parallelism: without these constraints the
        # whole MLA block would follow the replicated latents.
        q_nope = constrain(q_nope, "batch", "model", None, None)
        q_rope = constrain(q_rope, "batch", "model", None, None)
        k_nope = constrain(k_nope, "batch", "model", None, None)
        v = constrain(v, "batch", "model", None, None)
        c_kv = constrain(c_kv, "batch", None, None)
        k_rope = constrain(k_rope, "batch", None, None)
    def attend(q_nope, q_rope, k_nope, v, k_rope):
        s = (torch.einsum("bhqk,bhsk->bhqs", q_nope, k_nope)
             + torch.einsum("bhqk,bsk->bhqs", q_rope, k_rope)
             ).to(torch.float32) * _scale(cfg, q_nope.device)
        idx = torch.arange(q_nope.shape[2], device=q_nope.device)
        w = _softmax(s, (idx[:, None] >= idx[None, :])[None, None], dt)
        return torch.einsum("bhqs,bhsk->bhqk", w, v)

    o = by_heads(attend, q_nope, q_rope, k_nope, v, batch=(k_rope,))
    if cfg.sp_attn:
        o = constrain(o, "batch", "model", None, None)
    return x + _out_proj(o, p["wo"], dt)


def mla_cache_shape(cfg: ModelConfig, batch: int, max_len: int):
    return {
        "c_kv": (batch, max_len, cfg.kv_lora_rank),
        "k_rope": (batch, max_len, cfg.rope_head_dim),
    }


def mla_init_cache(cfg, batch, max_len, device):
    dtype = getattr(torch, cfg.cache_dtype)
    return {n: torch.zeros(s, dtype=dtype, device=device)
            for n, s in mla_cache_shape(cfg, batch, max_len).items()}


def mla_prefill(p, x, cfg, positions, max_len):
    out = mla_forward(p, x, cfg, positions)
    xn = rms_norm(x, p["norm"])
    c_kv, k_rope = _latents(p, xn, positions, cfg)

    def fill(c_kv, k_rope):
        cache = mla_init_cache(cfg, c_kv.shape[0], max_len, c_kv.device)
        cache["c_kv"][:, :c_kv.shape[1]] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][:, :k_rope.shape[1]] = k_rope.to(cache["k_rope"].dtype)
        return cache

    return out, on_shards(fill, c_kv, k_rope, whole=(1, 2))


def mla_decode(p, x, cache, cfg, pos: int):
    """Single-token decode; naive or absorbed per cfg.mla_absorb.  Writes
    the token's latent into ``cache`` in place and returns it."""
    xn = rms_norm(x, p["norm"])
    dt = xn.dtype
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _queries(p, xn, posv, cfg)       # [B,H,1,·]
    c_new, kr_new = _latents(p, xn, posv, cfg)        # [B,1,·]

    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    s_max = c_kv.shape[1]
    slot = min(pos, s_max - 1)   # JAX's dynamic_update_slice clamps
    c_kv[:, slot] = c_new[:, 0].to(c_kv.dtype)
    k_rope[:, slot] = kr_new[:, 0].to(k_rope.dtype)
    valid = (torch.arange(s_max, device=x.device) <= pos)[None, None, None]
    ckv = c_kv.to(dt)
    krope = k_rope.to(dt)

    if cfg.mla_absorb:
        # Score in latent space; W_uk folded into q, W_uv applied to the
        # attention-weighted latent.
        def attend(q_nope, q_rope, ckv, krope, wk_b, wv_b):
            q_lat = torch.einsum("bhqk,rhk->bhqr", q_nope, wk_b.to(dt))
            s = (torch.einsum("bhqr,bsr->bhqs", q_lat, ckv)
                 + torch.einsum("bhqk,bsk->bhqs", q_rope, krope)
                 ).to(torch.float32) * _scale(cfg, q_nope.device)
            w = _softmax(s, valid, dt)
            o_lat = torch.einsum("bhqs,bsr->bhqr", w, ckv)
            return torch.einsum("bhqr,rhk->bhqk", o_lat, wv_b.to(dt))

        o = by_heads(attend, q_nope, q_rope, batch=(ckv, krope),
                     weights=(p["wk_b"], p["wv_b"]))
    else:
        # Up-project the entire cached latent every step.
        k_nope = _proj(ckv, p["wk_b"])
        v = _proj(ckv, p["wv_b"])

        def attend(q_nope, q_rope, k_nope, v, krope):
            s = (torch.einsum("bhqk,bhsk->bhqs", q_nope, k_nope)
                 + torch.einsum("bhqk,bsk->bhqs", q_rope, krope)
                 ).to(torch.float32) * _scale(cfg, q_nope.device)
            w = _softmax(s, valid, dt)
            return torch.einsum("bhqs,bhsk->bhqk", w, v)

        o = by_heads(attend, q_nope, q_rope, k_nope, v, batch=(krope,))
    if cfg.sp_attn:
        o = constrain(o, "batch", "model", None, None)
    return x + _out_proj(o, p["wo"], dt), cache
