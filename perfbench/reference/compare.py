"""The numbers that decide ``correct``, each the worst over what was kept."""
from __future__ import annotations

import math

import torch


def sample_errors(got: torch.Tensor, ref: torch.Tensor,
                  block: int = 1 << 16) -> dict:
    """Posterior samples against the reference, over every node and sample:
    ``max_err`` = max |got − ref| and ``rms_err`` = rms(got − ref), both over
    rms(ref).  A missing or non-finite entry reads as infinite."""
    if got is None or tuple(got.shape) != tuple(ref.shape):
        return {"max_err": math.inf, "rms_err": math.inf}
    worst = sq = ref_sq = 0.0
    for s in range(0, ref.shape[0], block):
        d = got[s:s + block].to(ref.dtype) - ref[s:s + block]
        if not bool(torch.isfinite(d).all()):
            return {"max_err": math.inf, "rms_err": math.inf}
        worst = max(worst, float(d.abs().max()))
        sq += float(torch.sum(d * d))
        ref_sq += float(torch.sum(ref[s:s + block] ** 2))
    scale = math.sqrt(ref_sq / ref.numel())
    return {"max_err": worst / scale,
            "rms_err": math.sqrt(sq / ref.numel()) / scale}


def rel_gap(got: float, ref: float, scale: float) -> float:
    if got is None or not math.isfinite(got):
        return math.inf
    return abs(got - ref) / scale


def worst(into: dict, got: dict) -> None:
    """Keep, for each number, the largest reading so far."""
    for k, v in got.items():
        into[k] = max(into.get(k, 0.0), v)
