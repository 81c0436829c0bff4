"""GShard-style top-k mixture-of-experts FFN (port of ``repro/models/moe.py``:
moonshot 64 experts top-6, deepseek-v2 2 shared + 160 routed top-6).

Routing runs in float32: softmax over the router logits, top-k, gates
renormalised over the k choices, a capacity of ``max(int(S·k/E·cf), 4)``
slots per expert **per batch row**, and tokens past an expert's capacity
dropped (their gate weight is lost, as in the JAX package).  Two
implementations (``cfg.moe_impl``), which give the same function:

  * ``"einsum"`` — one-hot dispatch [B,S,E,C] and combine tensors, and the
    expert inputs and outputs through einsums against them;
  * ``"gather"`` — the token of each (expert, slot) in an int [B,E,C]
    table built with ``scatter_reduce(..., "amax")``, the expert inputs
    gathered from it, and each token's k outputs gathered back.

The load-balancing aux loss is Switch/GShard's E · Σ_e f_e · p_e."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import build
from .config import ModelConfig
from .layers import KeyGen, dense_init, residual, rms_norm


def init_moe(kg: KeyGen, cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "norm": torch.zeros((d,), dtype=torch.float32, device=kg.device),
        "router": dense_init(kg(), (d, e)),
        "w_gate": dense_init(kg(), (e, d, f)),
        "w_up": dense_init(kg(), (e, d, f)),
        "w_down": dense_init(kg(), (e, f, d), scale=f**-0.5),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared_gate"] = dense_init(kg(), (d, fs))
        p["shared_up"] = dense_init(kg(), (d, fs))
        p["shared_down"] = dense_init(kg(), (fs, d), scale=fs**-0.5)
    return p


def route(p: dict, xn: torch.Tensor, cfg: ModelConfig):
    """(probs [B,S,E], gate_vals [B,S,k] renormalised, gate_idx [B,S,k]),
    all from float32 router logits."""
    # The logits' gradient meets the aux loss's: keep both on the batch
    # layout (layers.residual) so that the router's matmul can flatten them.
    logits = residual(xn @ p["router"].to(xn.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), gate_idx


def capacity(cfg: ModelConfig, s: int) -> int:
    return max(int(s * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 4)


def _expert_ffn(xe, w_gate, w_up, w_down):
    dt = xe.dtype
    h = F.silu(torch.einsum("becd,edf->becf", xe, w_gate.to(dt)))
    h = h * torch.einsum("becd,edf->becf", xe, w_up.to(dt))
    return torch.einsum("becf,efd->becd", h, w_down.to(dt))


def _routed(dispatch, combine, xn, w_gate, w_up, w_down):
    """The einsum implementation's expert path: dispatch the tokens into
    their experts' slots [B,E,C,D], the experts' SwiGLU, combine back."""
    dt = xn.dtype
    xe = torch.einsum("bsec,bsd->becd", dispatch.to(dt), xn)
    ye = _expert_ffn(xe, w_gate, w_up, w_down)
    return torch.einsum("bsec,becd->bsd", combine.to(dt), ye)


def _routed_sharded(dispatch, combine, xn, w_gate, w_up, w_down):
    """:func:`_routed` of DTensors, expert-parallel in one ``local_map``
    region: batch rows over the data axes and experts over ``model``
    (where each divides), every expert's weights whole on the rank that
    holds its slots.  Each rank combines its own experts' outputs, so the
    result is a partial sum over ``model``; the weights' gradients are
    partial sums over the batch's ranks, the tokens' over the experts'.
    (DTensor's own einsums flatten (slots, experts) with the experts split,
    which it does not do.)"""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from ..launch import sharding as shr

    mesh = xn.device_mesh
    b, _, e, _ = dispatch.shape
    lead = shr.batch_spec(mesh, b, 1)
    ex = shr._div(mesh, "model", e)
    slots = shr.placements(lead + (None, ex, None), mesh)
    tokens = shr.placements(lead + (None, None), mesh)
    weights = shr.placements((ex, None, None), mesh)
    out = tuple(Partial() if s.is_shard(2) else t for s, t in zip(slots, tokens))
    pls = (slots, slots, tokens, weights, weights, weights)
    run = local_map(_routed, out_placements=(out,), in_placements=pls,
                    in_grad_placements=tuple(build.grad_placements(pl, slots)
                                             for pl in pls),
                    redistribute_inputs=True, device_mesh=mesh)
    return run(dispatch, combine, xn, w_gate, w_up, w_down)


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: [B, S, D] → (x + y, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    xn = rms_norm(x, p["norm"])
    dt = xn.dtype
    probs, gate_vals, gate_idx = route(p, xn, cfg)
    cap = capacity(cfg, s)

    onehot = F.one_hot(gate_idx, e).to(torch.float32)             # [B,S,k,E]
    # Position of each (token, choice) in its expert's queue.
    pos = torch.cumsum(onehot.reshape(b, s * k, e), dim=1).reshape(b, s, k, e) * onehot - 1.0
    keep = (pos >= 0) & (pos < cap)
    pos_i = torch.where(keep, pos, 0.0).to(torch.int64)

    experts = (p["w_gate"], p["w_up"], p["w_down"])
    if cfg.moe_impl == "einsum":
        pos_onehot = F.one_hot(pos_i, cap).to(torch.float32) * keep[..., None]
        dispatch = torch.einsum("bske,bskec->bsec", onehot, pos_onehot)
        combine = dispatch * torch.einsum("bsk,bske->bse", gate_vals, onehot)[..., None]
        routed = _routed_sharded if build.is_dtensor(xn) else _routed
        y = routed(dispatch, combine, xn, *experts)
    else:
        kept = keep & (onehot > 0)                                 # [B,S,k,E]
        dev = x.device
        tok_ids = torch.arange(s, device=dev)[None, :, None, None].expand(kept.shape)
        slot_e = torch.arange(e, device=dev)[None, None, None, :].expand(kept.shape)
        batch_ids = torch.arange(b, device=dev)[:, None, None, None].expand(kept.shape)
        flat_keep = kept.reshape(-1)
        flat_tok = torch.where(flat_keep, tok_ids.reshape(-1), 0)
        flat_slot = torch.where(
            flat_keep, (batch_ids * e + slot_e).reshape(-1) * cap + pos_i.reshape(-1),
            b * e * cap)                       # dropped → a discard slot
        table = torch.zeros((b * e * cap + 1,), dtype=torch.int64, device=dev)
        token_for_slot = table.scatter_reduce(0, flat_slot, flat_tok, "amax")[:-1]
        slot_live = table.scatter_reduce(0, flat_slot, flat_keep.to(torch.int64),
                                         "amax")[:-1]
        token_for_slot = token_for_slot.reshape(b, e, cap)
        rows = torch.arange(b, device=dev)[:, None, None]
        xe = xn[rows, token_for_slot]                              # [B,E,C,D]
        xe = xe * slot_live.reshape(b, e, cap)[..., None].to(dt)
        ye = _expert_ffn(xe, *experts)                             # [B,E,C,D]
        # Each (token, choice) reads its expert's output slot.
        choice_pos = (pos_i * onehot.to(torch.int64)).sum(-1)       # [B,S,k]
        flat_out_idx = gate_idx * cap + choice_pos
        picked = ye.reshape(b, e * cap, d)[torch.arange(b, device=x.device)[:, None, None],
                                           flat_out_idx]           # [B,S,k,D]
        w = (gate_vals * keep.any(dim=-1).to(torch.float32)).to(dt)
        y = torch.einsum("bskd,bsk->bsd", picked, w)

    if cfg.n_shared_experts:
        hs = F.silu(xn @ p["shared_gate"].to(dt)) * (xn @ p["shared_up"].to(dt))
        y = y + hs @ p["shared_down"].to(dt)

    frac_tokens = onehot.sum(2).mean(dim=(0, 1))                   # [E]
    mean_prob = probs.mean(dim=(0, 1))                             # [E]
    aux = e * torch.sum(frac_tokens / k * mean_prob)
    return x + y, aux
