"""Rank-r pivoted Nyström preconditioner for H = K̂ + D (port of
``repro/solvers/nystrom.py``).

The GRF estimator is already low-rank-structured — K̂ = ΦΦᵀ with explicit
feature rows — so a Nyström approximation is nearly free: pick r pivot rows
S of Φ and precondition with M = (K̂_nys + D)⁻¹, K̂_nys = C W⁻¹ Cᵀ,
C = Φ Φ_Sᵀ [T, r], W = Φ_S Φ_Sᵀ [r, r].

**Pivot rule.**  Greedy *residual*-diagonal selection — partial pivoted
Cholesky of K̂: repeatedly take the row with the largest remaining diagonal,
append its residual-orthogonalised K̂ column as a factor column, and
downdate the diagonal.  After r steps F Fᵀ is the Nyström approximation for
that pivot set in factored form (B = F), and the greedy rule spreads pivots
across correlated row clusters.  Each step is one ``dispatch.gram_block``
column (the sparse×sparse kernel); the loop stays on the device — the pivot
is a device tensor, never read on the host.

**Apply.**  Woodbury, M⁻¹v = D⁻¹v − D⁻¹B E⁻¹ BᵀD⁻¹v with E = I_r + BᵀD⁻¹B,
O(T·r) per CG iteration; E⁻¹ is formed once from the r×r Cholesky at build
time and every apply is one ``dispatch.woodbury_apply`` (the CUDA kernel on
the card).

**Adaptive rank.**  ``select_rank``/``resolve_strategy`` size r by
measurement: a short batched Lanczos probe (``cg_solve_fixed(...,
with_coeffs=True)``) yields Ritz values θ and Gauss-quadrature weights that
estimate the eigen-count N(x) ≈ #{λ_i(H) > x}; a CG cost model (√κ
iteration law × per-iteration and setup costs in matvec-equivalent units)
scores each r in AUTO_RANKS and the cheapest wins — rank 0 (Jacobi) when the
spectrum's head is too wide for any affordable r.  The JAX package's
constants are kept as they are.

Heteroscedastic noise vectors D and the masked sandwich M K̂ M + D are both
supported (the mask scales the feature rows).  Operators with a ``reduce``
hook (the row-sharded path), chunked or cross operators and bare callables
cannot serve pivot rows: :func:`nystrom_precond` raises on them and
:func:`resolve_strategy` falls back to Jacobi.  The JAX resolver also falls
back under a jit trace; the port has no trace, so it always measures.
"""
from __future__ import annotations

import math

import torch

from ..core import features, linops
from ..kernels import dispatch
from .cg import cg_solve_fixed
from .slq import rademacher, tridiag_from_coeffs
from .strategy import AUTO_RANKS, DEFAULT_PRECOND_RANK, SolveStrategy


def _pivoted_cholesky(vals: torch.Tensor, cols: torch.Tensor,
                      d0: torch.Tensor, rank: int):
    """Greedy partial pivoted Cholesky of K̂ = ΦΦᵀ from the ELL payload.

    Returns (F [T, rank], pivots [rank] int32) with F Fᵀ ≈ K̂.  Exhausted
    residuals write zero factor columns, and already-picked rows are masked
    to −∞ in the argmax, so pivots stay distinct past the numerical rank.
    A Python loop of ``rank`` steps with no host read: the pivot index is a
    one-element device tensor."""
    t = vals.shape[0]
    dev = vals.device
    fmat = torch.zeros((t, rank), dtype=vals.dtype, device=dev)
    piv = torch.zeros((rank,), dtype=torch.int32, device=dev)
    taken = torch.zeros((t,), dtype=torch.bool, device=dev)
    neg_inf = torch.full_like(d0, -math.inf)
    d = d0
    for i in range(rank):
        p = torch.argmax(torch.where(taken, neg_inf, d)).reshape(1)
        g = dispatch.gram_block(vals, cols, vals.index_select(0, p),
                                cols.index_select(0, p))[:, 0]
        proj = fmat @ fmat.index_select(0, p)[0]   # columns ≥ i are still zero
        dp = d.index_select(0, p)
        l = (g - proj) / torch.sqrt(torch.clamp(dp, min=1e-12))
        l = torch.where(dp > 1e-10, l, torch.zeros_like(l))
        fmat[:, i] = l
        d = torch.clamp(d - l * l, min=0.0)
        taken = taken.index_fill(0, p, True)
        piv[i:i + 1] = p.to(torch.int32)
    return fmat, piv


def pivot_rows(trace, f: torch.Tensor, rank: int) -> torch.Tensor:
    """Top-``rank`` row indices of Φ by greedy residual-diagonal pivoting —
    the Nyström pivot rule, shared with
    ``gp.variational.init_inducing_pivoted``."""
    vals = features.feature_values(trace, f)
    d0 = features.khat_diag_exact(trace, f)
    _, piv = _pivoted_cholesky(vals, trace.cols, d0, rank)
    return piv


def check_operator(h) -> str | None:
    """Why ``h`` can't take a Nyström preconditioner, or None if it can."""
    if not isinstance(h, linops.ShiftedOperator):
        return ("nystrom preconditioner needs a ShiftedOperator (H = K̂ + D) "
                "so the pivot rows and noise diagonal are recoverable; got "
                f"{type(h)}")
    phi_op = h.khat.rows
    if not isinstance(phi_op, linops.PhiOperator) or phi_op is not h.khat.cols:
        return ("nystrom preconditioner needs a *square* K̂ over a "
                "materialised trace (PhiOperator rows); chunked/cross "
                "operators can't serve pivot rows — use preconditioner='jacobi'")
    if h.khat.reduce is not None:
        return ("nystrom preconditioner is not available on the row-sharded "
                "path (the Nyström factor columns span shards); sharded "
                "strategies keep preconditioner='jacobi'")
    return None


class NystromApply:
    """M⁻¹v via the Woodbury kernel; O(T·r) per apply.

    ``rank``, ``pivots`` and :meth:`logdet` (log det(K̂_nys + D) by the
    matrix determinant lemma) for introspection."""

    def __init__(self, b, dinv, einv, d, l_e, pivots):
        self.rank = b.shape[1]
        self.pivots = pivots
        self._b, self._dinv, self._einv = b, dinv, einv
        self._d, self._l_e = d, l_e

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return dispatch.woodbury_apply(self._b, self._dinv, self._einv, v)

    def logdet(self) -> torch.Tensor:
        """log det(K̂_nys + D) = Σ log d + 2 Σ log diag(L_E)."""
        return (torch.sum(torch.log(torch.clamp(self._d, min=1e-30)))
                + 2.0 * torch.sum(torch.log(torch.diagonal(self._l_e))))


def nystrom_precond(h, rank: int | None = None,
                    jitter: float = 1e-6) -> NystromApply:
    """Build the Woodbury apply v ↦ M⁻¹v for a materialised-trace operator.

    ``h`` must be a :class:`repro_torch.core.linops.ShiftedOperator` whose K̂
    is square over a materialised :class:`PhiOperator`.  ``rank=None``
    resolves to ``strategy.DEFAULT_PRECOND_RANK``; the rank is clamped to
    T.  ``jitter`` guards the inner r×r Cholesky."""
    reason = check_operator(h)
    if reason is not None:
        raise ValueError(reason)
    if rank is None:
        rank = DEFAULT_PRECOND_RANK

    phi_op = h.khat.rows
    trace, f = phi_op.trace, phi_op.f
    t = trace.cols.shape[0]
    r = min(rank, t)

    vals = features.feature_values(trace, f)
    d0 = features.khat_diag_exact(trace, f)
    if h.mask is not None:
        # M K̂ M in factored form: scale the feature rows by the mask.
        vals = vals * h.mask[:, None]
        d0 = d0 * h.mask * h.mask
    b, piv = _pivoted_cholesky(vals, trace.cols, d0, r)

    d = torch.broadcast_to(torch.as_tensor(h.noise, dtype=b.dtype,
                                           device=b.device), (t,))
    dinv = torch.where(d > 0, 1.0 / torch.clamp(d, min=1e-30),
                       torch.ones_like(d))
    eye = torch.eye(r, dtype=b.dtype, device=b.device)
    e = eye + b.T @ (dinv[:, None] * b)
    l_e = torch.linalg.cholesky(e + jitter * eye)
    # Row-major once here, so no apply copies it.
    einv = torch.cholesky_solve(eye, l_e).contiguous()
    return NystromApply(b, dinv, einv, d, l_e, piv)


# ---------------------------------------------------------------------------
# Adaptive rank: size the pivot budget by measurement.
# ---------------------------------------------------------------------------


def _operator_device(h):
    """The device of an operator's trace, or None for a bare callable."""
    try:
        return h.khat.rows.trace.cols.device
    except AttributeError:
        return None


def _default_generator() -> torch.Generator:
    # Drawn on the host, so the card and the CPU probe with the same numbers.
    return torch.Generator().manual_seed(0)


def probe_spectrum(h, generator: torch.Generator | None = None,
                   n_iters: int = 24, n_probes: int = 4, device=None):
    """(θ, w): Ritz values of H and eigen-count quadrature weights.

    One batched ``n_iters``-step unpreconditioned CG pass over Rademacher
    probes — SLQ's (α,β) → tridiagonal → Gauss-quadrature plumbing read off
    for another integral: N(x) = #{λ_i(H) > x} ≈ Σ_k w_k · 1[θ_k > x].
    The probes come from ``generator`` (default: a host generator seeded 0)
    and are moved to ``device`` (default: the operator's)."""
    if generator is None:
        generator = _default_generator()
    if device is None:
        device = _operator_device(h)
    t = h.shape[0]
    z = rademacher(generator, (t, n_probes), device=device)
    _, coeffs = cg_solve_fixed(h, z, iters=min(n_iters, t), with_coeffs=True)
    theta, vecs = torch.linalg.eigh(tridiag_from_coeffs(coeffs))  # [S, m, m]
    tau2 = vecs[:, 0, :] ** 2                                      # e₁ weights
    w = coeffs.bnorm2[:, None] * tau2 / n_probes                   # Σw ≈ T
    return theta.reshape(-1), w.reshape(-1)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for increasing ``xp``, flat stretches
    included: constant outside [xp[0], xp[-1]], and a zero-width interval
    takes its left value (a width at or below spacing(eps), as jnp tests)."""
    i = torch.clamp(torch.searchsorted(xp, x.reshape(1), right=True)[0],
                    1, xp.shape[0] - 1)
    dx = xp[i] - xp[i - 1]
    flat = torch.abs(dx) <= _FLAT[xp.dtype]
    f = torch.where(flat, fp[i - 1], fp[i - 1] + (x - xp[i - 1])
                    / torch.where(flat, torch.ones_like(dx), dx)
                    * (fp[i] - fp[i - 1]))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


# np.spacing(np.finfo(dtype).eps): the widths jnp.interp treats as zero.
_FLAT = {torch.float32: 1.4210855e-14, torch.float64: 4.930380657631324e-32}


def _spectral_quantile(theta: torch.Tensor, w: torch.Tensor, r) -> torch.Tensor:
    """λ̂_{r+1}: the estimated (r+1)-th largest eigenvalue of H — the level x
    at which the quadrature's eigen-count CDF reaches r."""
    order = torch.argsort(-theta, stable=True)
    th, cw = theta[order], torch.cumsum(w[order], dim=0)
    return _interp(torch.as_tensor(r, dtype=th.dtype, device=th.device), cw, th)


# Cost-model constants, in matvec-equivalents, as the JAX package
# calibrated them on its CPU bench systems: the Woodbury apply adds ≈ 0.5 %
# of a matvec per unit of rank per iteration, and the pivoted-Cholesky setup
# costs ≈ 0.37 iterations per unit of rank.  Only relative cost ranks the
# candidates.
_WOODBURY_COST = 0.005        # per-iteration multiplier per unit of rank
_SETUP_COST = 0.37            # setup, in iteration-equivalents per rank


def rank_costs(h, generator: torch.Generator | None = None, ranks=AUTO_RANKS,
               tol: float = 1e-6, n_iters: int = 24,
               n_probes: int = 4) -> list[tuple[int, float, float]]:
    """(rank, predicted iterations, cost) for each candidate rank, in order.

    For each r the √κ law predicts iterations, κ_r ≈ λ̂_{r+1}/λ_min after
    the preconditioner removes the top-r head, and the cost charges the
    per-iteration Woodbury apply plus the one-off pivoted setup, in units of
    one unpreconditioned iteration."""
    theta, w = probe_spectrum(h, generator, n_iters=n_iters, n_probes=n_probes)
    lam_min = torch.clamp(torch.min(theta), min=1e-12)
    lam_max = torch.maximum(torch.max(theta), lam_min)
    t = h.shape[0]
    iters_scale = 0.5 * math.log(2.0 / max(tol, 1e-12))
    out = []
    for r in ranks:
        r = int(min(r, t))
        if r == 0:
            kappa = lam_max / lam_min
            per_iter, setup = 1.0, 0.0
        else:
            lam_r = torch.clamp(_spectral_quantile(theta, w, r), lam_min, lam_max)
            kappa = lam_r / lam_min
            per_iter = 1.0 + _WOODBURY_COST * r
            setup = _SETUP_COST * r
        iters = iters_scale * float(torch.sqrt(kappa))
        out.append((r, iters, setup + iters * per_iter))
    return out


def select_rank(h, generator: torch.Generator | None = None, ranks=AUTO_RANKS,
                tol: float = 1e-6, n_iters: int = 24, n_probes: int = 4) -> int:
    """Measured rank choice: argmin of the CG cost model over ``ranks``
    (:func:`rank_costs`; the first of equal costs wins).  Rank 0 (Jacobi)
    wins when the head is too wide to capture."""
    best_rank, best_cost = 0, None
    for r, _, cost in rank_costs(h, generator, ranks, tol, n_iters, n_probes):
        if best_cost is None or cost < best_cost:
            best_rank, best_cost = r, cost
    return best_rank


def resolve_strategy(h, strategy: SolveStrategy, *,
                     generator: torch.Generator | None = None,
                     n_iters: int = 24, n_probes: int = 4) -> SolveStrategy:
    """Resolve ``preconditioner="auto"`` into a concrete strategy for ``h``.

    Runs the spectral probe and returns ``"nystrom"`` with the measured
    rank, or ``"jacobi"`` when rank 0 wins or the operator can't serve pivot
    rows (sharded, chunked, bare callables).  Consumers resolve once at
    entry and reuse the resolved strategy across refits (gp/mll and
    bo/thompson do)."""
    if strategy.preconditioner != "auto":
        return strategy
    if check_operator(h) is not None:
        return strategy.with_(preconditioner="jacobi")
    rank = select_rank(h, generator, tol=strategy.tol, n_iters=n_iters,
                       n_probes=n_probes)
    if rank == 0:
        return strategy.with_(preconditioner="jacobi")
    return strategy.with_(preconditioner="nystrom", precond_rank=rank)
