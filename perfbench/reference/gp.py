"""GRF-GP arithmetic of the paper in float64: feature products, conjugate
gradients, pathwise posterior samples (Eq. 12) and the LML surrogate's
value and gradient (Eq. 9–10) with Adam.

Φ is built from its walk trace (cols, loads, lens) and a modulation f:
Φ[m, cols[m, k]] += loads[m, k]·f[lens[m, k]].  Products are sparse CSR
products; the gradient's per-slot sums are blocked over rows so that the
gathered [rows, K, R] block stays near ``BLOCK_BYTES``.
"""
from __future__ import annotations

import math
import warnings

import torch

F64 = torch.float64
BLOCK_BYTES = 1 << 29


def diffusion_f(log_beta, log_sigma_f, l_max: int) -> torch.Tensor:
    """Diffusion-shape modulation f_l = √σ_f·e^{−β/2}(β/2)^l / l!."""
    beta = torch.exp(log_beta)
    ls = torch.arange(l_max + 1, dtype=beta.dtype, device=beta.device)
    log_fact = torch.cumsum(torch.log(torch.clamp(ls, min=1.0)), dim=0)
    logf = -beta / 2.0 + ls * torch.log(beta / 2.0) - log_fact
    return torch.sqrt(torch.exp(log_sigma_f)) * torch.exp(logf)


class Features:
    """Rows of Φ from a walk trace and a float64 modulation ``f``, held as
    sparse CSR matrices Φ and Φᵀ (duplicate columns of a row summed)."""

    def __init__(self, cols, loads, lens, f, n_nodes: int):
        self.cols = cols
        self.loads = loads
        self.lens = lens
        self.n_nodes = n_nodes
        m, k = cols.shape
        live = loads != 0
        rows = torch.arange(m, device=cols.device)[:, None].expand(m, k)[live]
        c = cols[live].long()
        v = loads[live].to(F64) * f.to(F64)[lens[live].long()]
        self.csr = _csr(rows, c, v, (m, n_nodes))
        self._csr_t = None

    def _blocks(self, width: int):
        m, k = self.cols.shape
        step = max(1, BLOCK_BYTES // (8 * k * max(width, 1)))
        for s in range(0, m, step):
            yield s, min(s + step, m)

    def matvec(self, u: torch.Tensor) -> torch.Tensor:
        """Φ u: u [N, R] → [M, R]."""
        return self.csr @ u

    def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
        """Φᵀ v: v [M, R] → [N, R] (Φᵀ built on first use)."""
        if self._csr_t is None:
            self._csr_t = self.csr.t().to_sparse_csr()
        return self._csr_t @ v

    def khat(self, v: torch.Tensor) -> torch.Tensor:
        """K̂ v = Φ Φᵀ v for the square block (rows == columns)."""
        return self.matvec(self.rmatvec(v))

    def slot_grad(self, row_coef: torch.Tensor, dense: torch.Tensor):
        """Σ_r row_coef[m, r]·dense[cols[m, k], r] → ∂/∂f_l, summed over the
        slots of length l and weighted by their loads: [l_max+1]."""
        n_len = int(self.lens.max()) + 1
        out = torch.zeros(n_len, dtype=F64, device=dense.device)
        for s, e in self._blocks(dense.shape[1]):
            d = torch.einsum("mr,mkr->mk", row_coef[s:e],
                             dense[self.cols[s:e].long()])
            out.index_add_(0, self.lens[s:e].reshape(-1).long(),
                           (self.loads[s:e].to(F64) * d).reshape(-1))
        return out


def _csr(rows, cols, vals, shape):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "beta" notices
        coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape,
                                      check_invariants=False)
        return coo.coalesce().to_sparse_csr()


def cg(matvec, b: torch.Tensor, tol: float, max_iters: int):
    """Plain conjugate gradients on every column of b to ‖r‖ ≤ tol·‖b‖;
    (x, iterations).  Raises if ``max_iters`` is reached first: a reference
    that did not converge decides nothing."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = torch.sum(r * r, dim=0)
    bnorm = torch.sqrt(rr)
    it = 0
    while it < max_iters and bool(torch.any(torch.sqrt(rr) > tol * bnorm)):
        hp = matvec(p)
        alpha = rr / torch.sum(p * hp, dim=0)
        x += alpha * p
        r -= alpha * hp
        rr_new = torch.sum(r * r, dim=0)
        p = r + (rr_new / rr) * p
        rr = rr_new
        it += 1
    if bool(torch.any(torch.sqrt(rr) > tol * bnorm)):
        raise RuntimeError(f"reference CG did not reach {tol} in {it} "
                           "iterations")
    return x, it


def pathwise_samples(phi: Features, phi_x: Features, train, y, w, eps,
                     sigma2: float, tol: float, max_iters: int):
    """Eq. 12: g + K̂_{·x}(K̂_xx + σ²I)⁻¹(y − g_x − σ·eps), g = Φw."""
    g = phi.matvec(w)
    resid = y[:, None] - (g[train.long()] + math.sqrt(sigma2) * eps)
    v, _ = cg(lambda p: phi_x.khat(p) + sigma2 * p, resid, tol, max_iters)
    g += phi.matvec(phi_x.rmatvec(v))
    return g


def surrogate_step(cols, loads, lens, n_nodes: int, theta: dict, y, z,
                   l_max: int, tol: float, max_iters: int):
    """One step of the LML surrogate at hyperparameters ``theta``
    (float64 scalars ``log_beta``, ``log_sigma_f``, ``log_sigma_n``):
    (loss, datafit, gradient dict, CG iterations).

    s(θ) = −½ v_yᵀH v_y + ½·mean_s v_sᵀH z_s with v = H⁻¹[y, z] held
    fixed, so ∇s is the Hutchinson estimate of ∇(−log p(y|θ))."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in theta.items()}
    f = diffusion_f(leaves["log_beta"], leaves["log_sigma_f"], l_max)
    s2 = torch.exp(2.0 * leaves["log_sigma_n"])
    phi = Features(cols, loads, lens, f.detach(), n_nodes)
    s2v = float(s2.detach())
    h = lambda p: phi.khat(p) + s2v * p                          # noqa: E731
    b = torch.cat([y[:, None], z], dim=1)
    v, it = cg(h, b, tol, max_iters)
    v_y, v_z = v[:, :1], v[:, 1:]
    n_probes = z.shape[1]
    loss = (-0.5 * torch.sum(v_y * h(v_y))
            + 0.5 * torch.mean(torch.sum(v_z * h(z), dim=0)))
    datafit = 0.5 * torch.sum(y * v_y[:, 0])
    # ∂s/∂vals[m, k] = −v_y[m]·(Φᵀv_y)[c] + (1/2P)Σ_s (v_s[m](Φᵀz_s)[c]
    #                   + z_s[m](Φᵀv_s)[c]), with c = cols[m, k].
    dense = phi.rmatvec(torch.cat([v_y, z, v_z], dim=1))
    coef = torch.cat([-v_y, v_z / (2 * n_probes), z / (2 * n_probes)], dim=1)
    df = phi.slot_grad(coef, dense)[: l_max + 1]
    ds2 = (-0.5 * torch.sum(v_y * v_y)
           + torch.sum(v_z * z) / (2 * n_probes))
    grads = torch.autograd.grad([f, s2], list(leaves.values()),
                                [df, ds2.reshape(())])
    return (float(loss), float(datafit),
            dict(zip(leaves, (g.detach() for g in grads))), it)


def adam_update(theta: dict, grads: dict, state: dict, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One Adam step (ε added to √v̂); returns new params, updates state."""
    state["t"] = t = state.get("t", 0) + 1
    out = {}
    for k, g in grads.items():
        m = state.setdefault("m", {}).get(k, torch.zeros_like(g))
        v = state.setdefault("v", {}).get(k, torch.zeros_like(g))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        state["m"][k], state["v"][k] = m, v
        out[k] = theta[k] - lr * (m / (1 - b1**t)) / (torch.sqrt(v / (1 - b2**t))
                                                     + eps)
    return out
