"""Counter-based RNG of the walk sampler, plain PyTorch version.

Port of ``repro/kernels/walk_sampler/rng.py``: a murmur3-style chain keyed
on (seed, start node, walker, counter), so a node's walks depend only on its
absolute id (chunked == monolithic, subset rows == full rows).  The CUDA
kernel (``csrc/walk_sampler.cu``) evaluates the same hash natively on
uint32.

PyTorch on the CPU has no shifts on uint32, so the hash runs on int64
tensors holding values in [0, 2³²).  Every uint32 product is formed from
16-bit halves of the constant — each partial product stays below 2⁴⁸ — so
nothing relies on signed overflow, and the result is masked back to 32 bits.
"""
from __future__ import annotations

import torch

SCHEMES = ("iid", "antithetic", "qmc", "grfspp")

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_M3 = 0x27D4EB2F
# Walker-slot salt for the QMC digital shift: keys the per-(node, step)
# scramble on a coordinate no real walker id ever takes.
_QMC_SALT = 0xFFFFFFFF

_INV_2_24 = float(2.0**-24)


def _u32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """Values as int64 in [0, 2³²) (Python ints, int32 or int64 tensors)."""
    if not isinstance(x, torch.Tensor):
        dev = like.device if like is not None else None
        x = torch.as_tensor(x, dtype=torch.int64, device=dev)
    return x.to(torch.int64) & _MASK


def _mul32(h: torch.Tensor, const: int) -> torch.Tensor:
    """(h · const) mod 2³² for h in [0, 2³²), without int64 overflow."""
    lo = h * (const & 0xFFFF)
    hi = ((h * (const >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer — bijective avalanche mix on uint32."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    h = h ^ (h >> 16)
    return h


def counter_bits(seed, node, walker, ctr) -> torch.Tensor:
    """uint32 hash of the draw coordinate (broadcasts over tensor args)."""
    like = next((a for a in (node, walker, ctr, seed)
                 if isinstance(a, torch.Tensor)), None)
    h = _u32(seed, like) ^ _GOLDEN
    h = fmix32(h ^ _mul32(_u32(node, like), _M1))
    h = fmix32(h ^ _mul32(_u32(walker, like), _M2))
    h = fmix32(h ^ _mul32(_u32(ctr, like), _M3))
    return h


def _to_uniform(bits: torch.Tensor) -> torch.Tensor:
    return (bits >> 8).to(torch.float32) * _INV_2_24


def counter_uniform(seed, node, walker, ctr) -> torch.Tensor:
    """f32 uniform in [0, 1) from the top 24 bits of the counter hash."""
    return _to_uniform(counter_bits(seed, node, walker, ctr))


def bitrev32(x) -> torch.Tensor:
    """Bit-reversal on uint32 — the base-2 radical inverse times 2³²."""
    x = _u32(x)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & _MASK


def halt_uniform(seed, node, walker, ctr, *, scheme: str) -> torch.Tensor:
    """Scheme-dependent f32 uniform driving walk *termination*."""
    if scheme in ("iid", "grfspp"):
        return counter_uniform(seed, node, walker, ctr)
    if scheme == "antithetic":
        # Pairs (2k, 2k+1) read the even partner's stream; the odd walker
        # mirrors it (1−u is exact in f32 for u in [0, 1)).
        w = _u32(walker, node if isinstance(node, torch.Tensor) else None)
        u = counter_uniform(seed, node, w & 0xFFFFFFFE, ctr)
        return torch.where((w & 1) == 1, 1.0 - u, u)
    if scheme == "qmc":
        # Digitally-shifted van der Corput over the walkers of one
        # (node, ctr), scrambled by an XOR shift from the counter chain.
        shift = counter_bits(seed, node, _QMC_SALT, ctr)
        return _to_uniform(bitrev32(walker).to(shift.device) ^ shift)
    raise ValueError(f"unknown walk scheme {scheme!r}; valid: {SCHEMES}")
