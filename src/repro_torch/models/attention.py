"""GQA attention with sliding window, softcap, cross-attention and KV caches
(port of ``repro/models/attention.py``).

Prefill and full-sequence attention go through
``kernels/flash_attention/ops.attention``: on the card that is always the
hand-written kernel, whatever ``cfg.use_pallas_attn`` or ``cfg.attn_impl``
say; on the CPU ``attn_impl="chunked"`` selects the plain ``mha_chunked_ref``
and anything else the plain ``mha_ref``, as in the JAX package.  Decode is
plain tensor code in float32 on either device (memory-bound, one query row
per head), as the JAX package leaves it to XLA.

Sliding-window layers keep *ring-buffer* KV caches of size ``window``: slot
``p % window`` holds position ``p``.  :func:`attn_decode` writes the new
token's K/V into the cache in place (the caller owns the cache; the JAX
version returns a new one) and returns the same tensors.

Cross-attention (``kind="cross_attn"``) takes K and V from ``enc_out`` (the
encoder's output or the vision stub's patch embeddings), without RoPE and
without a causal mask; its cache holds those K/V (``enc_seq`` or
``n_vis_tokens`` long) and decode reads it as it is.

Not ported yet, and raising NotImplementedError: ``cfg.sp_attn``
(activation sharding needs ``launch/sharding.py``, ROADMAP Queue 1 #9c)."""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attention import ops as flash_ops
from .config import LayerSpec, ModelConfig
from .layers import KeyGen, dense_init, rms_norm, rope

NOT_PORTED = ("is not ported yet (ROADMAP Queue 1 #9c: sharding specs and "
              "cost accounting)")


def _supported(cfg: ModelConfig) -> None:
    if cfg.sp_attn:
        raise NotImplementedError(
            f"sp_attn (activation sharding over launch/sharding.py) {NOT_PORTED}")


def init_attn(kg: KeyGen, cfg: ModelConfig) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "norm": torch.zeros((d,), dtype=torch.float32, device=kg.device),
        "wq": dense_init(kg(), (d, h, hd)),
        "wk": dense_init(kg(), (d, hkv, hd)),
        "wv": dense_init(kg(), (d, hkv, hd)),
        "wo": dense_init(kg(), (h, hd, d), scale=(h * hd) ** -0.5),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bhsk"): [B, S, D] × [D, H, hd] → [B, H, S, hd] (a
    transposed view of the [B, S, H·hd] product)."""
    b, s, _ = x.shape
    _, h, hd = w.shape
    return (x @ w.to(x.dtype).reshape(w.shape[0], h * hd)).reshape(b, s, h, hd).transpose(1, 2)


def _out_proj(o: torch.Tensor, wo: torch.Tensor, dtype) -> torch.Tensor:
    """einsum("bhsk,hkd->bsd"): [B, H, S, hd] × [H, hd, D] → [B, S, D]."""
    b, h, s, hd = o.shape
    return o.transpose(1, 2).reshape(b, s, h * hd) @ wo.to(dtype).reshape(h * hd, -1)


def _project_qkv(p, xn, cfg, positions=None, kv_source=None):
    """Returns q [B,H,S,hd], k/v [B,Hkv,Skv,hd] (roped when positions given;
    K/V from ``kv_source`` when given)."""
    src = xn if kv_source is None else kv_source.to(xn.dtype)
    q = _proj(xn, p["wq"])
    k = _proj(src, p["wk"])
    v = _proj(src, p["wv"])
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(q, k, v, cfg: ModelConfig, spec: LayerSpec):
    return flash_ops.attention(
        q, k, v,
        causal=spec.causal and spec.kind != "cross_attn",
        window=spec.window,
        softcap=cfg.attn_logit_softcap,
        use_pallas=cfg.use_pallas_attn,
        impl="pallas" if cfg.use_pallas_attn else cfg.attn_impl,
        block_k=cfg.attn_block_k,
    )


def attn_forward(
    p: dict,
    x: torch.Tensor,                  # [B, S, D]
    cfg: ModelConfig,
    spec: LayerSpec,
    positions: torch.Tensor,          # [S]
    enc_out: torch.Tensor | None = None,  # cross-attention memory [B, S_enc, D]
) -> torch.Tensor:
    """Full-sequence attention (train / prefill)."""
    _supported(cfg)
    xn = rms_norm(x, p["norm"])
    cross = spec.kind == "cross_attn"
    q, k, v = _project_qkv(p, xn, cfg, positions=None if cross else positions,
                           kv_source=enc_out if cross else None)
    o = _attend(q, k, v, cfg, spec)
    return x + _out_proj(o, p["wo"], x.dtype)


# ---------------------------------------------------------------------------
# KV caches.
# ---------------------------------------------------------------------------

def attn_cache_shape(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int):
    """Cache entry {k, v}: ring buffer of ``window`` for SWA layers; the
    encoder's (or vision stub's) length for cross-attention."""
    if spec.kind == "cross_attn":
        s = cfg.enc_seq or cfg.n_vis_tokens
    elif spec.window is not None:
        s = min(spec.window, max_len)
    else:
        s = max_len
    hd = cfg.resolved_head_dim
    shape = (batch, cfg.n_kv_heads, s, hd)
    return {"k": shape, "v": shape}


def attn_init_cache(cfg, spec, batch, max_len, device):
    shapes = attn_cache_shape(cfg, spec, batch, max_len)
    dtype = getattr(torch, cfg.cache_dtype)
    return {n: torch.zeros(s, dtype=dtype, device=device) for n, s in shapes.items()}


def attn_prefill(p, x, cfg, spec, positions, max_len, enc_out=None):
    """Forward + produce the decode cache (window layers keep the tail;
    cross-attention keeps the K/V of ``enc_out``)."""
    _supported(cfg)
    xn = rms_norm(x, p["norm"])
    cross = spec.kind == "cross_attn"
    q, k, v = _project_qkv(p, xn, cfg, positions=None if cross else positions,
                           kv_source=enc_out if cross else None)
    o = _attend(q, k, v, cfg, spec)
    out = _out_proj(o, p["wo"], x.dtype)

    dtype = getattr(torch, cfg.cache_dtype)
    b, hkv, s_len, hd = k.shape
    if cross:
        cache = {"k": k.to(dtype).contiguous(), "v": v.to(dtype).contiguous()}
    elif spec.window is not None:
        w = min(spec.window, max_len)
        # Ring buffer: position s lives at slot s % w; for a prefill of
        # length S the live entries are the last min(w, S) positions.
        t = min(w, s_len)
        start = s_len - t
        slots = (start + torch.arange(t, device=x.device)) % w
        cache = {}
        for name, src in (("k", k), ("v", v)):
            buf = torch.zeros((b, hkv, w, hd), dtype=dtype, device=x.device)
            buf[:, :, slots, :] = src[:, :, start:, :].to(dtype)
            cache[name] = buf
    else:
        cache = {}
        for name, src in (("k", k), ("v", v)):
            buf = torch.zeros((b, hkv, max_len, hd), dtype=dtype, device=x.device)
            buf[:, :, :s_len, :] = src.to(dtype)
            cache[name] = buf
    return x + out, cache


def attn_decode(p, x, cache, cfg, spec, pos: int):
    """Single-token decode. x: [B, 1, D]; pos: the position being generated.

    Writes the token's K/V into ``cache`` in place and returns it; a
    cross-attention layer reads its cache and leaves it as it is."""
    _supported(cfg)
    xn = rms_norm(x, p["norm"])
    dt = xn.dtype
    q = _proj(xn, p["wq"])
    if spec.kind == "cross_attn":
        o = flash_ops.attention(q, cache["k"].to(dt), cache["v"].to(dt),
                                causal=False, use_pallas=False)
        return x + _out_proj(o, p["wo"], dt), cache
    k_new = _proj(xn, p["wk"])
    v_new = _proj(xn, p["wv"])
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k_new = rope(k_new, posv, cfg.rope_theta)

    k, v = cache["k"], cache["v"]
    s_cache = k.shape[2]
    # JAX's dynamic_update_slice clamps the start into the buffer.
    slot = pos % s_cache if spec.window is not None else min(pos, s_cache - 1)
    k[:, :, slot] = k_new[:, :, 0].to(k.dtype)
    v[:, :, slot] = v_new[:, :, 0].to(v.dtype)

    idx = torch.arange(s_cache, device=x.device)
    if spec.window is not None:
        # Ring buffer: slot s holds absolute position p ≡ s (mod w), the
        # largest such p ≤ pos (floor-mod, as torch's % is for a positive
        # divisor).  All slots ≤ pos are valid.
        abs_pos = pos - ((pos - idx) % s_cache)
        valid = abs_pos >= 0
    else:
        valid = idx <= pos

    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    b, h, _, hd = q.shape
    hkv = kf.shape[1]
    g = h // hkv
    qf = q.to(torch.float32).reshape(b, hkv, g, hd)
    s = torch.einsum("bhgk,bhsk->bhgs", qf, kf) / math.sqrt(hd)
    if cfg.attn_logit_softcap is not None:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    s = s.masked_fill(~valid[None, None, None], -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bhsk->bhgk", w, vf).reshape(b, h, 1, hd).to(dt)
    return x + _out_proj(o, p["wo"], dt), {"k": k, "v": v}
