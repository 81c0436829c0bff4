"""Mamba2 block via the SSD (state-space duality) chunked algorithm
(arXiv:2405.21060; port of ``repro/models/ssm.py``): mamba2-2.7b and the
zamba2-7b hybrid backbone.

Train/prefill: a loop over sequence chunks (JAX's ``lax.scan``; the
``cfg.scan_unroll`` knob of its dry-run changes nothing here).  Each chunk
does an intra-chunk pass, quadratic within Q = ``ssm_chunk``, plus the
inter-chunk state recurrence, all in float32.

Decode: O(1) recurrent update of (conv_state, ssm_state), written into the
cache in place.  The caches are float32 whatever ``cfg.cache_dtype`` says,
as in the JAX package."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import build
from .config import ModelConfig
from .layers import KeyGen, dense_init, rms_norm


def _dims(cfg: ModelConfig):
    din = cfg.expand * cfg.d_model
    nh = din // cfg.ssm_head_dim
    return din, nh, cfg.ssm_head_dim, cfg.ssm_state


def init_mamba(kg: KeyGen, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    din, nh, hd, ds = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=kg.device)
    return {
        "norm": torch.zeros((d,), **f32),
        "in_proj": dense_init(kg(), (d, 2 * din + 2 * ds + nh)),
        "conv_w": dense_init(kg(), (cfg.d_conv, din + 2 * ds), scale=0.5),
        "conv_b": torch.zeros((din + 2 * ds,), **f32),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "d_skip": torch.ones((nh,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.full((nh,), 0.01, **f32))),
        "out_norm": torch.zeros((din,), **f32),
        "out_proj": dense_init(kg(), (din, d), scale=din**-0.5),
    }


def _split_proj(zxbcdt, cfg):
    din, nh, hd, ds = _dims(cfg)
    return torch.split(zxbcdt, [din, din + 2 * ds, nh], dim=-1)   # z, xbc, dt


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv1d over [B, S, C]; optional [B, d_conv-1, C]
    state.  Returns (silu(conv + bias), the new state)."""
    dk = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], dk - 1, xbc.shape[2]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    out = sum(xp[:, i:i + s, :] * conv_w[i].to(xbc.dtype) for i in range(dk))
    return F.silu(out + conv_b.to(xbc.dtype)), xp[:, -(dk - 1):, :]


def _ssd_chunk_scan(xh, dt, a, bmat, cmat, chunk: int):
    """Chunked SSD.  xh [B,S,H,P], dt [B,S,H], a [H], bmat/cmat [B,S,N].

    Returns y [B,S,H,P] and the final state [B,H,N,P], float32."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        # dt = 0 on padded steps: decay exp(0) = 1 and no input, so the
        # state is unaffected; the padded outputs are sliced off below.
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    s_orig, s = s, s + pad
    c = s // q
    f32 = torch.float32
    xh = xh.reshape(b, c, q, h, p).to(f32)
    dt = dt.reshape(b, c, q, h).to(f32)
    bm = bmat.reshape(b, c, q, n).to(f32)
    cm = cmat.reshape(b, c, q, n).to(f32)
    da = dt * a                                   # [B,C,Q,H] (negative)
    iq = torch.arange(q, device=xh.device)
    causal = (iq[:, None] >= iq[None, :])[None, :, :, None]

    state = torch.zeros((b, h, n, p), dtype=f32, device=xh.device)
    ys = []
    for ci in range(c):
        xh_c, da_c, b_c, c_c, dt_c = xh[:, ci], da[:, ci], bm[:, ci], cm[:, ci], dt[:, ci]
        cum = torch.cumsum(da_c, dim=1)                       # [B,Q,H]
        seg = cum[:, :, None, :] - cum[:, None, :, :]         # cum_i − cum_j
        # exp of −inf above the diagonal: the JAX where(causal, exp(seg), 0)
        # in value, without an inf there whose gradient would be 0·inf.
        l_mat = torch.exp(seg.masked_fill(~causal, float("-inf")))
        xdt = xh_c * dt_c[..., None]                          # [B,Q,H,P]
        # Intra-chunk: y_i = Σ_j (C_i·B_j) L_ij xdt_j.
        cb = torch.einsum("bin,bjn->bij", c_c, b_c)
        y_intra = torch.einsum("bij,bijh,bjhp->bihp", cb, l_mat, xdt)
        # Inter-chunk: y_i += (C_i · S_prev) · exp(cum_i).
        y_inter = torch.einsum("bin,bhnp,bih->bihp", c_c, state, torch.exp(cum))
        # State: S = S·exp(total) + Σ_j B_j exp(total − cum_j) xdt_j.
        total = cum[:, -1:, :]
        decay_j = torch.exp(total - cum)
        state = state * torch.exp(total[:, 0, :])[:, :, None, None] + torch.einsum(
            "bjn,bjh,bjhp->bhnp", b_c, decay_j, xdt)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y[:, :s_orig], state


def _ssd(xh, dt, a, bmat, cmat, chunk: int):
    """:func:`_ssd_chunk_scan`; on DTensors shard by shard, in one
    ``local_map`` region (the scan's cumsum differentiates through a flip,
    which DTensor has no sharding of in every torch version).  Per mesh
    dim, xh's split batch splits every batched input, and its split heads
    split xh, dt and a (B and C, shared by the heads, kept whole, their
    gradients partial sums); anything else is replicated."""
    if not build.is_dtensor(xh):
        return _ssd_chunk_scan(xh, dt, a, bmat, cmat, chunk)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = xh.device_mesh
    h = xh.shape[2]
    pl = {k: [] for k in ("xh", "dt", "a", "bc", "state")}
    for i, p in enumerate(xh.placements):
        if p.is_shard(0):
            pick = dict(xh=p, dt=p, a=Replicate(), bc=p, state=p)
        elif p.is_shard(2) and h % mesh.size(i) == 0:
            pick = dict(xh=p, dt=p, a=Shard(0), bc=Replicate(), state=Shard(1))
        else:
            pick = dict.fromkeys(pl, Replicate())
        for k in pl:
            pl[k].append(pick[k])
    pl = {k: tuple(v) for k, v in pl.items()}
    ins = (pl["xh"], pl["dt"], pl["a"], pl["bc"], pl["bc"])
    run = local_map(lambda *t: _ssd_chunk_scan(*t, chunk),
                    out_placements=(pl["xh"], pl["state"]), in_placements=ins,
                    in_grad_placements=tuple(build.grad_placements(q, pl["xh"]) for q in ins),
                    redistribute_inputs=True, device_mesh=mesh)
    return run(xh, dt, a, bmat, cmat)


def mamba_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, return_state=False):
    """Full-sequence Mamba2 block. x: [B, S, D]; with ``return_state`` also
    the decode cache {conv, ssm} (float32)."""
    din, nh, hd, ds = _dims(cfg)
    xn = rms_norm(x, p["norm"])
    dt_ = xn.dtype
    z, xbc, dt = _split_proj(xn @ p["in_proj"].to(dt_), cfg)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xin, bmat, cmat = torch.split(xbc, [din, ds, ds], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])         # [B,S,H]
    a = -torch.exp(p["a_log"])                                    # [H]
    xh = xin.reshape(*xin.shape[:2], nh, hd)
    y, state = _ssd(xh, dt, a, bmat, cmat, cfg.ssm_chunk)
    y = y + p["d_skip"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(xin.shape).to(dt_)
    y = rms_norm(y * F.silu(z), p["out_norm"])
    out = x + y @ p["out_proj"].to(dt_)
    if return_state:
        return out, {"conv": conv_state.to(torch.float32), "ssm": state}
    return out


def mamba_cache_shape(cfg: ModelConfig, batch: int):
    din, nh, hd, ds = _dims(cfg)
    return {
        "conv": (batch, cfg.d_conv - 1, din + 2 * ds),
        "ssm": (batch, nh, ds, hd),
    }


def mamba_init_cache(cfg, batch, device, dtype=torch.float32):
    return {n: torch.zeros(s, dtype=dtype, device=device)
            for n, s in mamba_cache_shape(cfg, batch).items()}


def mamba_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """Single-token recurrent update. x: [B, 1, D].  Writes the new conv and
    SSM states into ``cache`` in place and returns it."""
    din, nh, hd, ds = _dims(cfg)
    b = x.shape[0]
    xn = rms_norm(x, p["norm"])
    dt_ = xn.dtype
    z, xbc, dt = _split_proj(xn @ p["in_proj"].to(dt_), cfg)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], cache["conv"])
    xin, bmat, cmat = torch.split(xbc, [din, ds, ds], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])[:, 0]  # [B,H]
    a = -torch.exp(p["a_log"])
    xh = xin.reshape(b, nh, hd).to(torch.float32)              # [B,H,P]
    bm = bmat[:, 0].to(torch.float32)                           # [B,N]
    cm = cmat[:, 0].to(torch.float32)
    decay = torch.exp(dt * a)                                   # [B,H]
    xdt = xh * dt[..., None]
    s_new = cache["ssm"] * decay[:, :, None, None] + torch.einsum("bn,bhp->bhnp", bm, xdt)
    y = torch.einsum("bn,bhnp->bhp", cm, s_new) + p["d_skip"][None, :, None] * xh
    y = y.reshape(b, 1, din).to(dt_)
    y = rms_norm(y * F.silu(z), p["out_norm"])
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(s_new)
    return x + y @ p["out_proj"].to(dt_), cache
