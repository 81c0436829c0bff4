"""Hutchinson probes (port of the part of ``repro/solvers/slq.py`` the
hyperparameter fit needs).

Stochastic Lanczos quadrature (``slq_logdet``) and the exact LML value come
with the Nyström/SLQ slice of the port.
"""
from __future__ import annotations

import torch


def rademacher(generator: torch.Generator, shape,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """±1 Hutchinson probes (E[zzᵀ] = I, ‖z‖² exact), drawn from
    ``generator`` on its own device and moved to ``device`` (default: the
    generator's)."""
    gdev = generator.device
    bits = torch.randint(0, 2, tuple(shape), generator=generator, device=gdev)
    z = bits.to(dtype) * 2.0 - 1.0
    return z if device is None else z.to(device)
