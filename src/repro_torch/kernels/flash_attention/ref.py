"""Plain PyTorch versions of blocked flash attention (MHA/GQA, window,
softcap): port of ``repro/kernels/flash_attention/ref.py``."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask(sq: int, kpos: torch.Tensor, causal: bool, window, q_offset: int,
          device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    mask = torch.ones((sq, kpos.shape[-1]), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def mha_ref(
    q: torch.Tensor,               # [B, H, Sq, D]
    k: torch.Tensor,               # [B, Hkv, Skv, D]
    v: torch.Tensor,               # [B, Hkv, Skv, D]
    *,
    causal: bool = True,
    window: int | None = None,     # sliding-window size (None = unbounded)
    softcap: float | None = None,  # gemma2-style logit soft-capping
    q_offset: int = 0,             # global position of q[0] (decode/prefill-chunk)
) -> torch.Tensor:
    """Dense attention in float32, output in q's dtype.  A row that sees no
    key averages all of them (the softmax of a row of -1e30), as the JAX
    oracle does."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.to(torch.float32).reshape(b, hkv, g, sq, d)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) / math.sqrt(d)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = _mask(sq, kpos, causal, window, q_offset, q.device)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    return o.reshape(b, h, sq, d).to(q.dtype)


def mha_chunked_ref(q, k, v, *, causal=True, window=None, softcap=None,
                    q_offset=0, block_k: int = 1024):
    """Flash-style attention as a loop over KV blocks of ``block_k``: the
    same semantics as :func:`mha_ref` (a row that sees no key gives 0, as the
    kernel does) with O(Sq·block_k) live memory, the online-softmax state
    (m, l, acc) carried across blocks."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    bk = min(block_k, skv)
    qf = q.to(torch.float32).reshape(b, hkv, g, sq, d)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, skv, bk):
        k_c = k[:, :, k0:k0 + bk].to(torch.float32)
        v_c = v[:, :, k0:k0 + bk].to(torch.float32)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k_c) / math.sqrt(d)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kpos = k0 + torch.arange(k_c.shape[2], device=q.device)[None, :]
        mask = _mask(sq, kpos, causal, window, q_offset, q.device)
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None]).masked_fill(~mask, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, v_c)
        m = m_new
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (acc / safe[..., None]).reshape(b, h, sq, d)
    return o.to(q.dtype)
