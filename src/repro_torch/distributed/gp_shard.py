"""Distributed GRF-GP: row-sharded features and one all-reduce per CG
iteration (port of ``repro/distributed/gp_shard.py``).

The paper's O(N^{3/2}) inference as a collective schedule:

  * Φ rows (the walk trace) are split over the ranks of a
    :class:`~repro_torch.launch.mesh.ServingMesh`; f and the scalars are
    the same on every rank.
  * K̂v = Φ(Φᵀv): Φᵀv is a *local* scatter-add into a full-length partial
    vector followed by ONE ``all_reduce`` (the only per-iteration
    collective of the operator); Φ·(·) is local to each rank's rows.
  * CG's inner products all-reduce one scalar per right-hand side.

The matvec is the port's own :class:`~repro_torch.core.linops.KhatOperator`
with the all-reduce injected as its ``reduce`` hook, and the solve is the
port's ``solvers.solve`` with the all-reducing ``dot`` hook — so with a
hook the operator composes the ``ell_spmv_t`` and ``ell_spmv`` kernels and
never runs the fused K̂ one.  Nyström preconditioning is excluded here
(the pivot cross-block spans ranks): ``"auto"`` resolves to ``"jacobi"``
and ``"nystrom"`` raises in ``solvers.nystrom_precond``.

JAX's ``shard_map`` is SPMD in one process; here each rank is a process
that holds the full inputs, slices its own rows ``mesh.rows(N)`` (as
``P("data")`` places them) and all-gathers its block of the result, so that
every rank returns the global array JAX returns.  Every rank must call
each function together, as a collective.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import solvers
from ..core import linops
from ..core.walks import DEFAULT_CHUNK, WalkConfig, WalkTrace
from ..graphs.formats import Graph
from ..solvers import SolveStrategy


def psum_reduce(mesh, compress: bool = False):
    """The all-reduce injected as the operators' ``reduce`` hook.

    ``compress`` computes the JAX package's function: there the partial is
    cast to bf16 and XLA upcasts the psum operand back to f32 before the
    all-reduce, so the sum runs in f32 over bf16-rounded partials.  Here
    the partial is rounded to bf16, cast back to f32 and all-reduced in f32
    — the wire carries f32, as in JAX (an NCCL bf16 all-reduce would sum in
    bf16: another function)."""

    def reduce(partial: torch.Tensor) -> torch.Tensor:
        out = (partial.to(torch.bfloat16).to(torch.float32) if compress
               else partial.clone())
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
        return out

    return reduce


def psum_dot(mesh):
    """Column-wise inner product summed over the ranks — the ``dot`` hook
    of ``solvers.solve`` (one all-reduce of one scalar per right-hand side
    each time CG takes an inner product)."""

    def dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        out = torch.sum(u * v, dim=0)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
        return out

    return dot


def _resolve(strategy, tol, max_iters, adaptive=True) -> SolveStrategy:
    """Fold per-call literals into a sharded-default strategy; ``"auto"``
    has no candidate but Jacobi here."""
    if strategy is None:
        strategy = solvers.SHARDED_DEFAULT
    if strategy.preconditioner == "auto":
        strategy = strategy.with_(preconditioner="jacobi")
    return strategy.with_overrides(
        tol=tol, max_iters=max_iters, adaptive=False if not adaptive else None
    )


def _gather_rows(local: torch.Tensor, mesh) -> torch.Tensor:
    """The global array from each rank's row block (every rank gets it)."""
    if mesh.size == 1:
        return local
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local.contiguous(), group=mesh.group)
    return torch.cat(parts)


def _local(trace: WalkTrace, rows: slice) -> WalkTrace:
    return WalkTrace(trace.cols[rows], trace.loads[rows], trace.lens[rows])


def sharded_h_operator(
    trace_local: WalkTrace,
    f: torch.Tensor,
    n_nodes: int,
    mesh,
    sigma_n2,
    mask: torch.Tensor | None = None,
    compress: bool = False,
) -> linops.ShiftedOperator:
    """H = (M) K̂ (M) + D over this rank's Φ rows, all-reduced."""
    return linops.shifted(trace_local, f, sigma_n2, n_nodes, mask=mask,
                          reduce=psum_reduce(mesh, compress))


def sharded_cg_solve(
    trace: WalkTrace,
    f: torch.Tensor,
    b: torch.Tensor,
    mesh,
    sigma_n2: float = 0.1,
    tol: float | None = None,
    max_iters: int | None = None,
    fixed_unrolled: bool = False,
    compress: bool = False,
    strategy: SolveStrategy | None = None,
    return_diagnostics: bool = False,
):
    """Solve (K̂ + σ²I) v = b with Φ rows split over the mesh's ranks.

    ``fixed_unrolled`` runs exactly ``max_iters`` iterations: the port's
    fixed-iteration CG (``solvers.cg_solve_fixed``, which has no early exit
    and no host read inside), where JAX unrolls the loop for its dry-run's
    cost analysis.  ``return_diagnostics=True`` also returns (iters_used,
    converged), the same on every rank (the convergence test runs on
    all-reduced inner products)."""
    strategy = _resolve(strategy, tol, max_iters, adaptive=not fixed_unrolled)
    n_nodes = trace.n_nodes
    rows = mesh.rows(n_nodes)
    h = sharded_h_operator(_local(trace, rows), f, n_nodes, mesh, sigma_n2,
                           compress=compress)
    res = solvers.solve(h, b[rows], strategy, dot=psum_dot(mesh))
    x = _gather_rows(res.x, mesh)
    if return_diagnostics:
        return x, res.iters, torch.all(res.converged)
    return x


def sharded_cg_solve_chunked(
    graph: Graph,
    f: torch.Tensor,
    b: torch.Tensor,
    mesh,
    seed: int,
    walk: WalkConfig,
    chunk: int = DEFAULT_CHUNK,
    sigma_n2: float = 0.1,
    tol: float | None = None,
    max_iters: int | None = None,
    strategy: SolveStrategy | None = None,
    return_diagnostics: bool = False,
):
    """Solve (K̂ + σ²I) v = b with *chunk-per-rank lazy* Φ rows.

    Each rank owns N/P rows of Φ that it never materialises: its
    ``ChunkedPhiOperator`` re-samples ``chunk``-row walk blocks (uint32
    walk ``seed``) per product, and the cross-rank reduction is the same
    all-reduce hook.  Peak memory per rank is O(chunk·K); the adjacency is
    whole on every rank (walkers cross row-block boundaries).  Equals
    :func:`sharded_cg_solve` on the trace sampled with the same seed."""
    strategy = _resolve(strategy, tol, max_iters)
    n_nodes = graph.n_nodes
    rows = mesh.rows(n_nodes)
    phi_local = linops.ChunkedPhiOperator(
        graph, f, seed, walk, chunk, n_rows=rows.stop - rows.start,
        row_start=rows.start)
    khat = linops.KhatOperator(phi_local, phi_local, reduce=psum_reduce(mesh))
    h = linops.ShiftedOperator(
        khat, torch.as_tensor(sigma_n2, dtype=torch.float32, device=b.device))
    res = solvers.solve(h, b[rows], strategy, dot=psum_dot(mesh))
    x = _gather_rows(res.x, mesh)
    if return_diagnostics:
        return x, res.iters, torch.all(res.converged)
    return x


def sharded_posterior_sample(
    trace: WalkTrace,
    train_mask: torch.Tensor,   # float32[N]: 1 for observed nodes
    f: torch.Tensor,
    y_full: torch.Tensor,       # float32[N]: observations scattered to rows
    generator: torch.Generator,
    mesh,
    sigma_n2: float = 0.1,
    max_iters: int | None = None,
    strategy: SolveStrategy | None = None,
    return_diagnostics: bool = False,
):
    """Pathwise posterior sample over all N nodes, row-sharded (Eq. 12).

    The training set is a mask, so every tensor stays row-sharded:
    H = M K̂ M + D with D = σ² on observed rows and 1e6 elsewhere.  The
    prior weights w [N] and the noise ε [N] are drawn from ``generator``
    whole on every rank (so every rank must pass a generator in the same
    state), and each rank takes its rows of ε: the sample does not depend
    on the number of ranks (JAX folds the shard index into ε's key
    instead).  With no strategy and no ``max_iters`` the 128-iteration
    budget applies."""
    if strategy is None and max_iters is None:
        max_iters = 128
    strategy = _resolve(strategy, None, max_iters)
    n_nodes = trace.n_nodes
    rows = mesh.rows(n_nodes)
    dev = trace.cols.device
    gdev = generator.device
    w = torch.randn((n_nodes,), generator=generator, device=gdev).to(dev)
    eps = torch.randn((n_nodes,), generator=generator, device=gdev).to(dev)
    mask, y = train_mask[rows], y_full[rows]
    noise = torch.where(mask > 0, torch.full_like(mask, sigma_n2),
                        torch.full_like(mask, 1e6))
    h = sharded_h_operator(_local(trace, rows), f, n_nodes, mesh, noise,
                           mask=mask)
    khat = h.khat
    g = khat.rows.matvec(w)
    resid = mask * (y - g - sigma_n2 ** 0.5 * eps[rows])
    res = solvers.solve(h, resid, strategy, dot=psum_dot(mesh))
    s = _gather_rows(g + khat.matvec(mask * res.x), mesh)
    if return_diagnostics:
        return s, res.iters, torch.all(res.converged)
    return s
