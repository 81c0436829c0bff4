"""Modulation functions f_l for GRF kernels (port of ``repro/core/modulation.py``).

With Ψ = Σ_l f_l Ã^l, ΨᵀΨ = K_α; the GP covariance is estimated as K̂ = ΦΦᵀ
with E[Φ] = Ψ, so hyperparameters enter only through the small vector
``f = (f_0, ..., f_{l_max})``.

Parameterisations (all return f scaled by √σ_f so K̂ carries σ_f² overall):
  * diffusion-shape: f_l = √σ_f · e^{-β/2} (β/2)^l / l!   → K = σ_f exp(-β L̃)
  * matern-shape:    f_l = √σ_f·c·Γ(ν/2+l)/(Γ(ν/2) l!) x^l with x = 1/(1+2ν/κ²)
  * learnable:       f_l free

``init(generator, device=None)`` returns the parameter dict on ``device``
(default: the CUDA card); ``fn`` works on the device of its parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import device as _device


@dataclasses.dataclass(frozen=True)
class Modulation:
    """A named, differentiable map params → f ∈ R^{l_max+1}."""

    name: str
    l_max: int
    fn: Callable[[dict], torch.Tensor]
    init: Callable[..., dict]  # (generator, device=None) -> params

    def __call__(self, params: dict) -> torch.Tensor:
        return self.fn(params)


def _arange(l_max: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(l_max + 1, dtype=torch.float32, device=like.device)


def _log_factorials(ls: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(torch.log(torch.clamp(ls, min=1.0)), dim=0)


def diffusion(l_max: int, init_beta: float = 1.0) -> Modulation:
    """Diffusion-shape modulation; learnable lengthscale β and variance σ_f."""

    def fn(params):
        beta = torch.exp(params["log_beta"])
        sigma_f = torch.exp(params["log_sigma_f"])
        ls = _arange(l_max, beta)
        logf = -beta / 2.0 + ls * torch.log(beta / 2.0) - _log_factorials(ls)
        return torch.sqrt(sigma_f) * torch.exp(logf)

    def init(generator=None, device=None):
        del generator
        dev = _device.resolve(device)
        return {
            "log_beta": torch.log(torch.tensor(init_beta, dtype=torch.float32,
                                               device=dev)),
            "log_sigma_f": torch.tensor(0.0, dtype=torch.float32, device=dev),
        }

    return Modulation("diffusion", l_max, fn, init)


def matern(l_max: int, nu: float = 1.5, init_kappa: float = 1.0) -> Modulation:
    """Matérn-shape modulation with fixed smoothness ν, learnable κ, σ_f."""
    half_nu = nu / 2.0

    def fn(params):
        kappa = torch.exp(params["log_kappa"])
        sigma_f = torch.exp(params["log_sigma_f"])
        ls = _arange(l_max, kappa)
        # log Γ(ν/2+l) − log Γ(ν/2) as a cumulative sum of log(ν/2 + k).
        log_poch = torch.cat([
            torch.zeros(1, device=kappa.device),
            torch.cumsum(torch.log(half_nu + ls[:-1]), dim=0),
        ])
        x = 1.0 / (1.0 + 2.0 * nu / kappa**2)
        logf = log_poch - _log_factorials(ls) + ls * torch.log(x)
        # c = (1-x)^{ν/2} normalises so that K(i,i) ≈ σ_f at lengthscale → 0.
        logc = half_nu * torch.log1p(-x)
        return torch.sqrt(sigma_f) * torch.exp(logc + logf)

    def init(generator=None, device=None):
        del generator
        dev = _device.resolve(device)
        return {
            "log_kappa": torch.log(torch.tensor(init_kappa, dtype=torch.float32,
                                                device=dev)),
            "log_sigma_f": torch.tensor(0.0, dtype=torch.float32, device=dev),
        }

    return Modulation("matern", l_max, fn, init)


def learnable(l_max: int, init_scale: float = 0.3, decay: float = 0.5) -> Modulation:
    """Fully-learnable modulation, initialised to a geometric decay + noise."""

    def fn(params):
        return params["f"]

    def init(generator=None, device=None):
        dev = _device.resolve(device)
        gen_dev = generator.device if generator is not None else "cpu"
        base = init_scale * decay ** torch.arange(l_max + 1.0)
        noise = 0.05 * torch.randn(l_max + 1, generator=generator,
                                   device=gen_dev).cpu()
        f = (base + noise).to(torch.float32)
        f[0] = 1.0
        return {"f": f.to(dev)}

    return Modulation("learnable", l_max, fn, init)


REGISTRY = {
    "diffusion": diffusion,
    "matern": matern,
    "learnable": learnable,
}
