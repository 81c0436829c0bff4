"""Shared building blocks of the LM scaffold: norms, rotary embeddings,
gated MLP, init (port of ``repro/models/layers.py``).

``rms_norm`` goes through the rmsnorm kernel's wrapper (the CUDA kernel on
the card, its plain version on the CPU); on the card it is differentiable
through an autograd Function whose backward runs the plain version
(kernels/rmsnorm/ops.py).  ``rope`` and ``swiglu`` are plain tensor code, as
the JAX package leaves them to XLA."""
from __future__ import annotations

import types

import torch
import torch.nn.functional as F

from ..kernels.rmsnorm import ops as rmsnorm_ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x·rsqrt(mean(x²) + eps)·(1 + scale) over the last dim, f32 math, x's
    dtype out."""
    return rmsnorm_ops.apply(x, scale, eps)


def on_shards(fn, x: torch.Tensor, *rest, whole: tuple = ()):
    """``fn(x, *rest)`` — on each rank's local shards when ``x`` is a DTensor.

    The DTensors among ``x`` and ``rest`` are first placed as ``x`` is,
    with the tensor dims in ``whole`` made whole (replicated); ``fn``'s
    tensor outputs come back as DTensors with those placements.  For code
    whose shapes DTensor cannot follow: a cache built by index writes."""
    from ..kernels import build

    if not build.is_dtensor(x):
        return fn(x, *rest)
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils import _pytree as pytree

    mesh = x.device_mesh
    pl = tuple(Replicate() if p.is_partial() or any(p.is_shard(d) for d in whole)
               else p for p in x.placements)
    args = [a.redistribute(mesh, pl).to_local() if build.is_dtensor(a) else a
            for a in (x, *rest)]
    return pytree.tree_map_only(
        torch.Tensor, lambda t: DTensor.from_local(t, mesh, pl, run_check=False),
        fn(*args))


def residual(x: torch.Tensor) -> torch.Tensor:
    """The residual stream's layout: a DTensor keeps its batch split over
    the data axes and nothing else (a pending partial sum is reduced, a
    split sequence or feature dim gathered).  DTensor would otherwise leave
    a reduce-scatter's split sequence in the stream, and a matmul of [B, S,
    D] flattens (B, S), which DTensor does only when S is whole.  The same
    holds for its gradient.  Plain tensors pass through."""
    from ..kernels import build

    return _Residual.apply(x) if build.is_dtensor(x) else x


def _batch_only(x):
    from torch.distributed.tensor import Replicate

    pl = tuple(p if p.is_shard(0) else Replicate() for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


class _Residual(torch.autograd.Function):
    """:func:`residual` in value and in gradient (the backward's reductions
    would otherwise leave the gradient's sequence split)."""

    @staticmethod
    def forward(ctx, x):
        return _batch_only(x)

    @staticmethod
    def backward(ctx, g):
        return _batch_only(g)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding.  x: [..., S, D_even]; positions: [S] or [B,S].

    Frequencies and angles in float32, the rotation in float32 (a bf16 x is
    promoted), then one cast back to x's dtype — as the JAX package does."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freq   # [..., S, half]
    while angles.dim() < x.dim():
        angles = angles[None]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """Gated MLP: down( silu(x·gate) ⊙ (x·up) ).  Weights cast to x's dtype."""
    h = F.silu(x @ w_gate.to(x.dtype)) * (x @ w_up.to(x.dtype))
    return h @ w_down.to(x.dtype)


def _trunc_normal(gen: torch.Generator, shape) -> torch.Tensor:
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    if t.is_meta:   # shapes only: nothing to draw
        return t
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)


def dense_init(gen: torch.Generator, shape, scale: float | None = None) -> torch.Tensor:
    """scale · truncated normal on [−2, 2] (default scale fan_in^-1/2)."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in**-0.5
    return _trunc_normal(gen, shape).mul_(scale)


def embed_init(gen: torch.Generator, vocab: int, d: int) -> torch.Tensor:
    # 1/√d so that embed·√d (the lookup scaling) has unit variance and the
    # tied unembedding produces O(1) logits at init.
    return _trunc_normal(gen, (vocab, d)).mul_(d**-0.5)


_META_KEY = types.SimpleNamespace(device=torch.device("meta"))


class KeyGen:
    """Deterministic generator dispenser for parameter init.

    The n-th call returns a fresh ``torch.Generator`` on ``device`` seeded
    from (seed, n), as the JAX KeyGen folds n into its key, so a leaf's
    values do not depend on the order of other draws.  The two packages draw
    different numbers from one seed: the tests carry the JAX parameters
    across instead (``interop.model_params_from_numpy``).  On the ``meta``
    device (shapes without storage, as the dry run builds them) it hands
    out a stand-in that names the device and draws nothing."""

    def __init__(self, seed: int, device):
        self._seed = int(seed)
        self.device = torch.device(device)
        self._n = 0

    def __call__(self) -> torch.Generator:
        self._n += 1
        if self.device.type == "meta":
            return _META_KEY
        gen = torch.Generator(device=self.device)
        return gen.manual_seed(self._seed * 1_000_003 + self._n)
