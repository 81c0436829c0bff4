"""GP hyperparameters and the solve operator (port of ``repro/gp/mll.py``,
the part the posterior needs).

``mll_surrogate_loss``, ``_fit_chunk`` and ``fit_hyperparams`` — the
hyperparameter fit that differentiates through the kernels — come with the
training slice of the port.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import device as _device
from ..core import linops
from ..core.modulation import Modulation
from ..core.walks import WalkTrace


def init_hyperparams(mod: Modulation, generator: torch.Generator | None = None,
                     init_noise: float = 0.1, device=None) -> dict:
    """{"mod": modulation params, "log_sigma_n": log σ_n} on ``device``."""
    dev = _device.resolve(device)
    return {
        "mod": mod.init(generator, device=dev),
        "log_sigma_n": torch.log(torch.tensor(init_noise, dtype=torch.float32,
                                              device=dev)),
    }


def noise_var(params: dict) -> torch.Tensor:
    return torch.exp(2.0 * params["log_sigma_n"])


def make_h_operator(
    trace_x: WalkTrace, f: torch.Tensor, sigma_n2, n_nodes: int
) -> linops.ShiftedOperator:
    """H = K̂_xx + D as an operator; ``sigma_n2`` is a scalar (σ_n² I) or a
    [T] vector (heteroscedastic diagonal)."""
    return linops.shifted(trace_x, f, sigma_n2, n_nodes)


def make_h_matvec(
    trace_x: WalkTrace, f: torch.Tensor, sigma_n2, n_nodes: int
) -> Callable:
    """Callable view of :func:`make_h_operator` (operators are callable)."""
    return make_h_operator(trace_x, f, sigma_n2, n_nodes)
