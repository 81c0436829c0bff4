"""Sparse variational GP classification with GRF kernels (port of
``repro/gp/variational.py``; paper §4.4, App. C.7).

Multi-class SVGP: C latent GPs share one GRF kernel; q(u_c) = N(μ_c, L_c L_cᵀ)
over M inducing nodes (whitened); softmax likelihood handled by a
Monte-Carlo ELBO.  The kernel blocks come from dense Φ rows of the inducing
and training nodes (``PhiOperator.take_rows(...).dense()``, differentiable
in the modulation), so K_uu [M, M], K_xu [T, M] and diag K_xx are plain
dense products.

Randomness: :func:`init_svgp` and :func:`elbo` draw from an explicit
``torch.Generator`` (on its device); :func:`elbo` hands its Monte-Carlo
draws ε [n_mc, T, C] to the private ``_elbo``, which takes ε as an
argument (the tests feed it the JAX package's draw).  A non-positive-definite
K_uu gives a NaN factor, as in the JAX package (``gp.exact.cholesky_or_nan``).

The M×M blocks stay direct (Cholesky) — the whitened parameterisation
needs the explicit factor L_uu.  :func:`init_inducing_pivoted` picks
inducing nodes by the Nyström preconditioner's greedy residual-diagonal
pivot rule (``solvers.pivot_rows``), so SVGP inducing selection and CG
preconditioning anchor on the same rows.
"""
from __future__ import annotations

import torch

from .. import device as _device
from ..core import linops
from ..core.modulation import Modulation
from ..core.walks import WalkTrace
from ..optim.adamw import AdamW
from ..solvers import pivot_rows
from .exact import cholesky_or_nan
from .mll import _value_and_grad


def init_inducing_pivoted(trace: WalkTrace, f: torch.Tensor,
                          n_inducing: int) -> torch.Tensor:
    """Inducing set by Nyström pivoting: greedy residual-diagonal selection.

    Returns **row indices into ``trace``** (node ids for a full-graph trace;
    for a sub-trace, map them through the rows that built it).  Greedy
    residual pivoting spreads the budget across correlated row clusters
    instead of stacking onto the highest-energy one."""
    return pivot_rows(trace, f, n_inducing)


def kernel_blocks(trace: WalkTrace, f: torch.Tensor, inducing, nodes,
                  n_nodes: int, jitter: float = 1e-4):
    """K_uu [M,M], K_xu [T,M] and diag K_xx [T] from GRF features (dense Φ
    rows; M, T small).  diag K_xx = Σ Φ_x², exact under duplicate columns."""
    phi = linops.phi(trace, f, n_nodes)
    phi_u = phi.take_rows(inducing).dense()
    phi_x = phi.take_rows(nodes).dense()
    m = phi_u.shape[0]
    k_uu = phi_u @ phi_u.T + jitter * torch.eye(m, dtype=phi_u.dtype,
                                                 device=phi_u.device)
    k_xu = phi_x @ phi_u.T
    k_xx_diag = torch.sum(phi_x * phi_x, dim=1)
    return k_uu, k_xu, k_xx_diag


def init_svgp(generator: torch.Generator, n_inducing: int, n_classes: int,
              mod: Modulation, device=None) -> dict:
    """Initial SVGP parameters on ``device``: the modulation's, μ (small
    normals from ``generator``) and Σ's Cholesky factor as identity ·
    exp(−2) (strictly-lower part + log-diagonal)."""
    dev = _device.resolve(device)
    mu = torch.randn((n_classes, n_inducing), generator=generator,
                     device=generator.device, dtype=torch.float32)
    return {
        "mod": mod.init(generator, device=dev),
        "mu": 0.01 * mu.to(dev),
        "log_scale_diag": torch.full((n_classes, n_inducing), -2.0,
                                     device=dev),
        "chol_lower": torch.zeros((n_classes, n_inducing, n_inducing),
                                  device=dev),
    }


def _chol_factor(params: dict) -> torch.Tensor:
    lower = torch.tril(params["chol_lower"], -1)
    return lower + torch.diag_embed(torch.exp(params["log_scale_diag"]))


def _whitened(params, trace, mod, inducing, nodes, n_nodes, jitter):
    """(A = L_uu⁻¹ K_uxᵀ [M, T], diag K_xx [T]) under ``params``."""
    f = mod(params["mod"])
    k_uu, k_xu, k_xx_diag = kernel_blocks(trace, f, inducing, nodes, n_nodes,
                                          jitter)
    luu = cholesky_or_nan(k_uu)
    a = torch.linalg.solve_triangular(luu, k_xu.T, upper=False)
    return a, k_xx_diag


def _elbo(params, eps, trace, mod, inducing, nodes, labels, n_nodes: int,
          jitter: float = 1e-4):
    """Monte-Carlo ELBO  Σ E_q[log softmax] − KL(q(u)‖p(u)) with the
    standard normals ``eps`` [n_mc, T, C] given."""
    a, k_xx_diag = _whitened(params, trace, mod, inducing, nodes, n_nodes,
                             jitter)
    m = a.shape[0]
    s_chol = _chol_factor(params)                 # [C, M, M]
    mu = params["mu"]                             # [C, M]

    # Marginal q(h_c(x)) under the whitened parameterisation.
    mean = torch.einsum("mt,cm->tc", a, mu)
    av = torch.einsum("mt,cmk->tck", a, s_chol)
    var = (k_xx_diag[:, None] - torch.sum(a * a, dim=0)[:, None]
           + torch.sum(av * av, dim=2))
    var = torch.clamp(var, min=1e-8)

    h = mean[None] + torch.sqrt(var)[None] * eps
    logp = torch.log_softmax(h, dim=-1)
    idx = labels.long()[None, :, None].expand(eps.shape[0], -1, 1)
    ll = torch.mean(torch.gather(logp, -1, idx))

    # KL between q(u) = N(mu, SSᵀ) and the whitened prior N(0, I), per class.
    tr = torch.sum(s_chol ** 2, dim=(1, 2))
    logdet_q = 2 * torch.sum(params["log_scale_diag"], dim=1)
    kl = 0.5 * torch.sum(tr + torch.sum(mu ** 2, dim=1) - m - logdet_q)
    t = nodes.shape[0]
    return ll * t - kl, {"ll": ll, "kl": kl}


def elbo(params, generator: torch.Generator, trace, mod, inducing, nodes,
         labels, n_nodes: int, n_classes: int, n_mc: int = 8,
         jitter: float = 1e-4):
    """Monte-Carlo ELBO with ε [n_mc, T, C] drawn from ``generator``."""
    eps = torch.randn((n_mc, nodes.shape[0], n_classes), generator=generator,
                      device=generator.device, dtype=torch.float32)
    return _elbo(params, eps.to(params["mu"].device), trace, mod, inducing,
                 nodes, labels, n_nodes, jitter)


def fit_svgp(
    trace, mod, inducing, nodes, labels, n_nodes: int, n_classes: int,
    generator: torch.Generator, steps: int = 300, lr: float = 0.05,
    n_mc: int = 8,
) -> dict:
    """Adam ascent on the ELBO; the initial parameters and every step's ε
    come from ``generator``.  Returns the fitted parameter dict."""
    params = init_svgp(generator, inducing.shape[0], n_classes, mod,
                       device=trace.cols.device)
    opt = AdamW(lr=lr)
    opt_state = opt.init(params)

    def loss_fn(p):
        e, aux = elbo(p, generator, trace, mod, inducing, nodes, labels,
                      n_nodes, n_classes, n_mc)
        return -e, aux

    for _ in range(steps):
        _, _, grads = _value_and_grad(params, loss_fn)
        params, opt_state = opt.update(grads, opt_state, params)
    return params


@torch.no_grad()
def predict_classes(params, trace, mod, inducing, nodes, n_nodes: int,
                    jitter: float = 1e-4) -> torch.Tensor:
    """The class with the largest posterior mean at each of ``nodes``."""
    a, _ = _whitened(params, trace, mod, inducing, nodes, n_nodes, jitter)
    mean = torch.einsum("mt,cm->tc", a, params["mu"])
    return torch.argmax(mean, dim=1)
