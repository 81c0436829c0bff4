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

``cfg.sp_attn`` constrains q, k, v and the output of full-sequence
attention as the JAX package does (:func:`_constrain_qkv`): a no-op unless
the launcher has registered an activation mesh and the tensors are
DTensors.  Sharded inputs reach the kernel shard by shard
(``flash_attention/ops.attention``); decode attention and the prefill
caches run on each rank's local shards too."""
from __future__ import annotations

import math

import torch

from ..kernels import build
from ..kernels.flash_attention import ops as flash_ops
from ..launch.sharding import axis_sizes, constrain, get_activation_mesh
from .config import LayerSpec, ModelConfig
from .layers import KeyGen, dense_init, on_shards, rms_norm, rope


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
    w2 = _whole_heads(_gather(w, 2).to(x.dtype).reshape(w.shape[0], h * hd), 1, h)
    y = _whole_heads(x @ w2, 2, h).reshape(b, s, h, hd)
    if build.is_dtensor(y):
        # The reshape's backward views its gradient, which arrives as the
        # transpose of a [B, H, S, hd] shard: DTensor's view needs it dense.
        y = _DenseGrad.apply(y)
    return y.transpose(1, 2)


def _out_proj(o: torch.Tensor, wo: torch.Tensor, dtype) -> torch.Tensor:
    """einsum("bhsk,hkd->bsd"): [B, H, S, hd] × [H, hd, D] → [B, S, D]."""
    b, h, s, hd = o.shape
    # The sequence-parallel region ends here: the product flattens (B, S).
    flat = _whole_heads(_gather(o, 2).transpose(1, 2).reshape(b, s, h * hd), 2, h)
    return flat @ _whole_heads(_gather(wo, 1).to(dtype).reshape(h * hd, -1), 0, h)


def _gather(t, dim: int):
    """The DTensor ``t`` made whole along ``dim`` (plain tensors pass
    through).  DTensor flattens a group of dims only where no dim but the
    first is sharded (torch 2.11 raises otherwise)."""
    if not build.is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    pl = tuple(Replicate() if p.is_shard(dim) else p for p in t.placements)
    return t if pl == tuple(t.placements) else t.redistribute(t.device_mesh, pl)


def _whole_heads(t, dim: int, h: int):
    """``t``, whose dim ``dim`` flattens (H heads, head dim).  A DTensor
    shard of that dim must hold whole heads for the (un)flatten: on a mesh
    dim that splits it where H does not divide, it is gathered, in value
    and in gradient.  Plain tensors pass through."""
    if not build.is_dtensor(t):
        return t
    return _WholeHeads.apply(t, dim, h)


def _gather_uneven(t, dim: int, h: int):
    from torch.distributed.tensor import Replicate

    mesh = t.device_mesh
    pl = tuple(Replicate() if p.is_shard(dim) and h % mesh.size(i) else p
               for i, p in enumerate(t.placements))
    # A gathered shard can come back strided; the (un)flatten views it.
    return t if pl == tuple(t.placements) else t.redistribute(mesh, pl).contiguous()


class _DenseGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


class _WholeHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim: int, h: int):
        ctx.dim, ctx.h = dim, h
        return _gather_uneven(t, dim, h)

    @staticmethod
    def backward(ctx, g):
        return _gather_uneven(g, ctx.dim, ctx.h), None, None


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


def _constrain_qkv(q, k, v):
    """Activation sharding for full-sequence attention.

    Head-parallel (Megatron) when the query heads divide the model axis —
    attention is then embarrassingly parallel per head; otherwise
    sequence-parallel: shard the QUERY sequence over model and replicate
    K/V (one all-gather per layer)."""
    mesh = get_activation_mesh()
    n_model = axis_sizes(mesh).get("model", 1) if mesh is not None else 1
    h, hkv = q.shape[1], k.shape[1]
    if n_model > 1 and h % n_model == 0:
        kv_ax = "model" if hkv % n_model == 0 else None
        q = constrain(q, "batch", "model", None, None)
        k = constrain(k, "batch", kv_ax, None, None)
        v = constrain(v, "batch", kv_ax, None, None)
        return q, k, v, ("batch", "model", None, None)
    q = constrain(q, "batch", None, "model", None)
    k = constrain(k, "batch", None, None, None)
    v = constrain(v, "batch", None, None, None)
    return q, k, v, ("batch", None, "model", None)


def _attend(q, k, v, cfg: ModelConfig, spec: LayerSpec):
    if cfg.sp_attn:
        q, k, v, o_spec = _constrain_qkv(q, k, v)
    o = flash_ops.attention(
        q, k, v,
        causal=spec.causal and spec.kind != "cross_attn",
        window=spec.window,
        softcap=cfg.attn_logit_softcap,
        use_pallas=cfg.use_pallas_attn,
        impl="pallas" if cfg.use_pallas_attn else cfg.attn_impl,
        block_k=cfg.attn_block_k,
    )
    return constrain(o, *o_spec) if cfg.sp_attn else o


def attn_forward(
    p: dict,
    x: torch.Tensor,                  # [B, S, D]
    cfg: ModelConfig,
    spec: LayerSpec,
    positions: torch.Tensor,          # [S]
    enc_out: torch.Tensor | None = None,  # cross-attention memory [B, S_enc, D]
) -> torch.Tensor:
    """Full-sequence attention (train / prefill)."""
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
    xn = rms_norm(x, p["norm"])
    cross = spec.kind == "cross_attn"
    q, k, v = _project_qkv(p, xn, cfg, positions=None if cross else positions,
                           kv_source=enc_out if cross else None)
    o = _attend(q, k, v, cfg, spec)
    out = _out_proj(o, p["wo"], x.dtype)

    dtype = getattr(torch, cfg.cache_dtype)
    if cross:
        cache = {"k": k.to(dtype).contiguous(), "v": v.to(dtype).contiguous()}
    else:
        cache = on_shards(lambda k, v: _prefill_cache(k, v, spec.window, max_len, dtype),
                          k, v, whole=(2,))
    return x + out, cache


def _prefill_cache(k, v, window, max_len: int, dtype) -> dict:
    """The decode cache of a prefill's K/V [B, Hkv, S, hd]: the first S
    slots of ``max_len``, or for a window layer its ring buffer."""
    b, hkv, s_len, hd = k.shape
    cache = {}
    if window is not None:
        w = min(window, max_len)
        # Ring buffer: position s lives at slot s % w; for a prefill of
        # length S the live entries are the last min(w, S) positions.
        t = min(w, s_len)
        start = s_len - t
        slots = (start + torch.arange(t, device=k.device)) % w
        for name, src in (("k", k), ("v", v)):
            buf = torch.zeros((b, hkv, w, hd), dtype=dtype, device=k.device)
            buf[:, :, slots, :] = src[:, :, start:, :].to(dtype)
            cache[name] = buf
    else:
        for name, src in (("k", k), ("v", v)):
            buf = torch.zeros((b, hkv, max_len, hd), dtype=dtype, device=k.device)
            buf[:, :, :s_len, :] = src.to(dtype)
            cache[name] = buf
    return cache


def attn_decode(p, x, cache, cfg, spec, pos: int):
    """Single-token decode. x: [B, 1, D]; pos: the position being generated.

    Writes the token's K/V into ``cache`` in place and returns it; a
    cross-attention layer reads its cache and leaves it as it is."""
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
    idx = torch.arange(s_cache, device=x.device)
    if spec.window is not None:
        # Ring buffer: slot s holds absolute position p ≡ s (mod w), the
        # largest such p ≤ pos (floor-mod, as torch's % is for a positive
        # divisor).  All slots ≤ pos are valid.
        abs_pos = pos - ((pos - idx) % s_cache)
        valid = abs_pos >= 0
    else:
        valid = idx <= pos
    args = (q, k_new, v_new, k, v, slot, valid, cfg.attn_logit_softcap)
    o = (_sharded_decode(*args) if build.is_dtensor(k) else _write_and_attend(*args))
    return x + _out_proj(o, p["wo"], dt), {"k": k, "v": v}


def _write_and_attend(q, k_new, v_new, k, v, slot: int, valid, softcap,
                      s_off: int = 0, groups: tuple = ()):
    """Write the token's K/V at ``slot`` and attend q [B, H, 1, hd] over the
    cache in float32.  With ``s_off`` and ``groups`` the cache is this
    rank's block of the sequence, from global slot ``s_off``: the softmax's
    max and sums are all-reduced over ``groups``, the ranks that hold the
    other blocks (flash-decoding)."""
    s_loc = k.shape[2]
    if s_off <= slot < s_off + s_loc:
        k[:, :, slot - s_off] = k_new[:, :, 0].to(k.dtype)
        v[:, :, slot - s_off] = v_new[:, :, 0].to(v.dtype)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    b, h, _, hd = q.shape
    hkv = kf.shape[1]
    g = h // hkv
    qf = q.to(torch.float32).reshape(b, hkv, g, hd)
    s = torch.einsum("bhgk,bhsk->bhgs", qf, kf) / math.sqrt(hd)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(~valid[s_off:s_off + s_loc][None, None, None], -1e30)
    if not groups:
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgs,bhsk->bhgk", w, vf)
    else:
        import torch.distributed as dist

        m = torch.amax(s, dim=-1, keepdim=True)
        for grp in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=grp)
        e = torch.exp(s - m)
        l = torch.sum(e, dim=-1, keepdim=True)
        o = torch.einsum("bhgs,bhsk->bhgk", e, vf)
        for grp in groups:
            dist.all_reduce(l, group=grp)
            dist.all_reduce(o, group=grp)
        o = o / l
    return o.reshape(b, h, 1, hd).to(q.dtype)


def _sharded_decode(q, k_new, v_new, k, v, slot, valid, softcap):
    """:func:`_write_and_attend` of DTensors, shard by shard.  The cache's
    placements lead: a mesh dim that splits its batch or kv heads splits q
    and the new K/V alike; one that splits its sequence keeps q and the new
    K/V whole, and its ranks combine their blocks' softmax terms."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = k.device_mesh
    coord = mesh.get_coordinate()
    pl, groups, s_off, chunk = [], [], 0, k.shape[2]
    for i, p in enumerate(k.placements):
        if p.is_shard(0) or p.is_shard(1):
            pl.append(p)
        elif p.is_shard(2):
            pl.append(Replicate())
            chunk //= mesh.size(i)
            s_off += coord[i] * chunk
            groups.append(mesh.get_group(i))
        else:
            pl.append(Replicate())
    q, k_new, v_new = (t.redistribute(mesh, pl) for t in (q, k_new, v_new))

    def local(ql, knl, vnl, kl, vl):
        return _write_and_attend(ql, knl, vnl, kl, vl, slot, valid, softcap,
                                 s_off, tuple(groups))

    return local_map(local, out_placements=(tuple(pl),), device_mesh=mesh)(
        q, k_new, v_new, k, v)
