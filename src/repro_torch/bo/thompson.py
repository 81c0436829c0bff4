"""Graph Thompson sampling with GRF-GPs (port of ``repro/bo/thompson.py``;
paper §4.3, Alg. 3).

Each BO iteration: (re)fit hyperparameters on the observation set (warm
started), draw a posterior sample, query the argmax among unobserved nodes.
Observations live in a preallocated [n_init + n_steps·batch_size] buffer
with an ``obs_mask``; padded slots carry ~infinite noise.

Two loop shapes share this module: :func:`thompson_sampling` (the paper's
refit loop — an N-long pathwise sample per round, on a materialised trace
or on the chunked million-node path) and
:func:`thompson_sampling_incremental` (the serving-shaped loop — one
``ServeState`` reused across the run, O(m²) Cholesky row-appends per
observation, joint Thompson draws over a candidate set).

Randomness: the JAX loops derive their numpy seed, walk key and per-round
keys from one ``jax.random`` key.  Here every stream derives from one
integer ``seed`` through ``numpy.random.SeedSequence`` (:func:`_stream`):
the numpy generator of the initial design, the uint32 walk seed (the
identity of Φ, fixed across rounds), the candidate sets, and one
``torch.Generator`` on the data's device per refit and per draw.

``preconditioner="auto"`` (in ``fit_strategy`` or ``sample_strategy``) is
resolved ONCE per run, on the first refit round's operator, as the JAX loops
do: T is the static buffer capacity and later rounds only flip mask slots,
so the measured rank keeps its meaning.

Observability (when ``obs`` is enabled): each round's draw is a
``bo.draw`` span, and each round bumps ``bo.rounds`` and
``bo.observations`` and sets the ``bo.incumbent_best`` (and, with
``f_max``, ``bo.incumbent_regret``) gauges.

Resume: ``checkpoint_cb`` is called with the :class:`BOState` after every
round, and ``state=`` resumes from one.  The driver twin
(examples/bo_social_network.py) saves the buffers and hyperparameters
through ``repro_torch.checkpoint.CheckpointManager`` from that callback and
rebuilds the state from the manager's latest step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import obs, solvers
from ..core import features, walks
from ..core.modulation import Modulation
from ..core.walks import DEFAULT_CHUNK, WalkConfig, WalkTrace
from ..gp import mll, posterior
from ..graphs.formats import Graph
from ..solvers import SolveStrategy

# Stream tags of :func:`_stream` (the JAX loops' fold_in constants where
# they have one).
_WALK, _NUMPY, _INIT, _FIT, _DRAW, _CAND = 7919, 0, 1, 1000, 2, 5003


def _stream(seed: int, *tags: int) -> int:
    """A 32-bit seed of its own for (seed, *tags): independent streams."""
    ss = np.random.SeedSequence([int(seed), *tags])
    return int(ss.generate_state(1, np.uint32)[0])


def _generator(seed: int, device, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(_stream(seed, *tags))


@dataclasses.dataclass
class BOState:
    """Everything needed to resume a BO run."""

    x_buf: np.ndarray          # int32[capacity] observed node ids (padded 0)
    y_buf: np.ndarray          # float32[capacity] observations (padded 0)
    count: int                 # live observations
    params: dict               # GP hyperparameters (warm start)
    regret: list               # simple regret per iteration
    iteration: int = 0

    @property
    def x_obs(self) -> np.ndarray:
        return self.x_buf[: self.count]

    @property
    def y_obs(self) -> np.ndarray:
        return self.y_buf[: self.count]


def _init_or_resume(state, n, n_init, capacity, rng_np, objective, mod,
                    generator, noise_std, batch_size, device):
    """Shared BO entry: draw the init set, or validate a resumed BOState.

    A resumed state must carry buffers at least ``capacity`` long and a
    count consistent with this run's n_init/batch_size."""
    if state is not None:
        slots = min(len(state.x_buf), len(state.y_buf))
        if slots < capacity or state.count > slots:
            raise ValueError(
                f"resumed BOState buffers hold {slots} slots "
                f"(count={state.count}) but this run needs {capacity} "
                "(n_init + n_steps*batch_size); resume with the same "
                "arguments as the original run"
            )
        expect = min(n_init, n) + state.iteration * batch_size
        if state.count != expect:
            raise ValueError(
                f"resumed BOState has count={state.count} at iteration "
                f"{state.iteration}, but n_init={n_init}/batch_size="
                f"{batch_size} imply {expect}; resume with the same "
                "arguments as the original run"
            )
        return state
    x0 = rng_np.choice(n, size=min(n_init, n), replace=False)
    y0 = np.asarray(objective(x0), dtype=np.float32)
    x_buf = np.zeros(capacity, dtype=np.int32)
    y_buf = np.zeros(capacity, dtype=np.float32)
    x_buf[: len(x0)] = x0
    y_buf[: len(x0)] = y0
    params = mll.init_hyperparams(mod, generator, init_noise=noise_std,
                                  device=device)
    return BOState(x_buf=x_buf, y_buf=y_buf, count=len(x0), params=params,
                   regret=[])


def _argmax_picks(samples: np.ndarray, ids, observed, batch_size: int):
    """One argmax per sample column, no duplicates within the round.

    ``samples`` is [len(ids), batch_size] (mutated); ``observed`` indexes
    rows of ``samples`` to exclude; ``ids`` maps rows to node ids."""
    samples[observed, :] = -np.inf
    picks = []
    for j in range(batch_size):
        row = int(np.argmax(samples[:, j]))
        if not np.isfinite(samples[row, j]):
            raise ValueError(
                "no unobserved candidates left to query (graph exhausted "
                "or candidate set fully observed); shrink n_steps or widen "
                "n_candidates"
            )
        picks.append(int(ids[row]))
        samples[row, :] = -np.inf  # no duplicate queries within a round
    return picks


def _record_round(state: BOState, picks, ys, f_max, checkpoint_cb, t):
    """Shared BO tail: append observations, track regret, checkpoint."""
    for x_t, y_t in zip(picks, ys):
        state.x_buf[state.count] = x_t
        state.y_buf[state.count] = float(y_t)
        state.count += 1
    obs.inc("bo.observations", len(picks))
    obs.inc("bo.rounds")
    if f_max is not None:
        regret = float(f_max - state.y_obs.max())
        state.regret.append(regret)
        obs.gauge("bo.incumbent_regret", regret)
    obs.gauge("bo.incumbent_best", float(state.y_obs.max()))
    state.iteration = t + 1
    if checkpoint_cb is not None:
        checkpoint_cb(state)


def _resolve_auto(strategies, trace_x, mod, params, mask, n):
    """Resolve each ``"auto"`` strategy on the refit round's operator."""
    if all(st.preconditioner != "auto" for st in strategies):
        return strategies
    with torch.no_grad():
        h0 = mll.make_h_operator(
            trace_x, mod(params["mod"]),
            torch.where(mask > 0, mll.noise_var(params),
                        torch.full_like(mask, 1e6)), n)
        return tuple(solvers.resolve_strategy(h0, st) for st in strategies)


def _refit(state, trace_x, mod, y_n, n, mask, seed, t, refit_steps,
           noise_std, fit_strategy, device):
    res = mll.fit_hyperparams(
        trace_x, mod, y_n, n, _generator(seed, device, _FIT, t),
        steps=refit_steps, lr=0.05, init_params=state.params,
        init_noise=noise_std, obs_mask=mask, chunk=refit_steps,
        strategy=fit_strategy,
    )
    state.params = res.params


def thompson_sampling(
    trace: WalkTrace | None,
    mod: Modulation,
    objective: Callable[[np.ndarray], np.ndarray],
    seed: int,
    n_init: int = 50,
    n_steps: int = 100,
    noise_std: float = 0.1,
    refit_every: int = 5,
    refit_steps: int = 15,
    f_max: float | None = None,
    state: BOState | None = None,
    checkpoint_cb: Callable[[BOState], None] | None = None,
    batch_size: int = 1,
    graph: Graph | None = None,
    walk: WalkConfig | None = None,
    chunk: int = DEFAULT_CHUNK,
    fit_strategy: SolveStrategy | None = None,
    sample_strategy: SolveStrategy | None = None,
) -> BOState:
    """Run Alg. 3. ``objective`` maps node ids → noisy observations.

    ``batch_size`` > 1 runs batched Thompson sampling: q independent
    pathwise posterior samples per round, one argmax each.

    Pass ``graph`` + ``walk`` (and ``trace=None``) for the *chunked*
    million-node path: the full-graph trace is never materialised; each
    posterior draw streams Φ in ``chunk``-row blocks and only the
    observation-set trace Φ_x ([capacity, K]) exists.  With a materialised
    trace, its walk seed is the caller's; the chunked path samples with the
    run's own walk seed.

    The refit default is the warm-started ``MLL_DEFAULT``, and the
    hyperparameters warm start from the previous round."""
    if fit_strategy is None:
        fit_strategy = solvers.MLL_DEFAULT
    if sample_strategy is None:
        sample_strategy = solvers.POSTERIOR_DEFAULT
    chunked = graph is not None
    if chunked and walk is None:
        raise ValueError("chunked Thompson sampling needs a WalkConfig")
    if not chunked and trace is None:
        raise ValueError(
            "pass either a materialised trace or graph= (+ walk=) for the "
            "chunked path"
        )
    n = graph.n_nodes if chunked else trace.n_nodes
    dev = graph.device if chunked else trace.cols.device
    walk_seed = _stream(seed, _WALK)  # Φ identity, fixed across rounds
    capacity = n_init + n_steps * batch_size
    rng_np = np.random.default_rng(_stream(seed, _NUMPY))
    state = _init_or_resume(state, n, n_init, capacity, rng_np, objective,
                            mod, _generator(seed, dev, _INIT), noise_std,
                            batch_size, dev)
    capacity = min(len(state.x_buf), len(state.y_buf))
    mask_np = np.zeros(capacity, dtype=np.float32)

    for t in range(state.iteration, n_steps):
        mask_np[:] = 0.0
        mask_np[: state.count] = 1.0
        mask = torch.from_numpy(mask_np.copy()).to(dev)
        x_all = torch.from_numpy(state.x_buf.copy()).to(dev)
        y_live = state.y_buf[: state.count]
        ymean = float(y_live.mean())
        ystd = float(y_live.std()) + 1e-8
        y_n = torch.from_numpy((state.y_buf - ymean) / ystd).to(dev) * mask

        if t % refit_every == 0:
            if chunked:
                # Φ_x rows via the counter RNG — identical to take_rows on
                # the (never materialised) full trace.
                trace_x = walks.sample_walks_for_nodes(
                    graph, x_all, walk_seed, walk.n_walkers, walk.p_halt,
                    walk.l_max, walk.reweight, walk.scheme,
                )
            else:
                trace_x = features.take_rows(trace, x_all)
            fit_strategy, sample_strategy = _resolve_auto(
                (fit_strategy, sample_strategy), trace_x, mod, state.params,
                mask, n)
            _refit(state, trace_x, mod, y_n, n, mask, seed, t, refit_steps,
                   noise_std, fit_strategy, dev)

        f = mod(state.params["mod"])
        s2 = mll.noise_var(state.params)
        gen = _generator(seed, dev, _DRAW, t)
        with obs.span("bo.draw", round=t, mode="pathwise") as sp:
            if chunked:
                samples = posterior.pathwise_samples_chunked(
                    graph, x_all, f, s2, y_n, gen, walk_seed, walk,
                    chunk=chunk, n_samples=batch_size, obs_mask=mask,
                    strategy=sample_strategy,
                )
            else:
                samples = posterior.pathwise_samples(
                    trace, x_all, f, s2, y_n, gen, n_samples=batch_size,
                    obs_mask=mask, strategy=sample_strategy,
                )
            sp.block_on(samples)
        # Mask observed nodes, pick one argmax per sample (Alg. 3 line 8).
        picks = _argmax_picks(samples.cpu().numpy(), np.arange(n),
                              state.x_obs, batch_size)
        ys = np.asarray(objective(np.array(picks)), dtype=np.float32)
        _record_round(state, picks, ys, f_max, checkpoint_cb, t)
    return state


def thompson_sampling_incremental(
    graph: Graph,
    walk: WalkConfig,
    mod: Modulation,
    objective: Callable[[np.ndarray], np.ndarray],
    seed: int,
    n_init: int = 50,
    n_steps: int = 100,
    noise_std: float = 0.1,
    refit_every: int = 5,
    refit_steps: int = 15,
    f_max: float | None = None,
    batch_size: int = 1,
    n_candidates: int | None = None,
    state: BOState | None = None,
    checkpoint_cb: Callable[[BOState], None] | None = None,
    fit_strategy: SolveStrategy | None = None,
) -> BOState:
    """Alg. 3 with one ``serving.ServeState`` reused end to end.

      * acquisition — one exact *joint* Thompson draw over a candidate set
        (``serving.thompson_draw``: a ``gram_block`` cross-Gram, a q×q
        ``gram_block`` and a q×q Cholesky; no CG, nothing N-long),
      * update — ``serving.observe_batch``: an O(m²) Cholesky row-append
        per new observation instead of a fresh fit,
      * hyperparameters — refit every ``refit_every`` rounds; only then is
        the m×m Gram refactorised (``serving.ingest``).

    ``n_candidates`` bounds the per-round candidate set (default: every
    node when N ≤ 2048, else 1024 uniform draws).  Resume via ``state=``;
    the ServeState is rebuilt from the BOState buffers on entry."""
    from .. import serving

    if fit_strategy is None:
        fit_strategy = solvers.MLL_DEFAULT
    n = graph.n_nodes
    dev = graph.device
    walk_seed = _stream(seed, _WALK)  # Φ identity, fixed across rounds
    capacity = n_init + n_steps * batch_size
    rng_np = np.random.default_rng(_stream(seed, _NUMPY))
    if n_candidates is None:
        n_candidates = n if n <= 2048 else 1024
    n_candidates = min(n_candidates, n)
    cand_seed = _stream(seed, _CAND)

    state = _init_or_resume(state, n, n_init, capacity, rng_np, objective,
                            mod, _generator(seed, dev, _INIT), noise_std,
                            batch_size, dev)
    capacity = min(len(state.x_buf), len(state.y_buf))
    mask_np = np.zeros(capacity, dtype=np.float32)
    serve = None
    ymean, ystd = 0.0, 1.0

    for t in range(state.iteration, n_steps):
        y_live = state.y_buf[: state.count]
        refit_now = t % refit_every == 0
        if refit_now or serve is None:
            if refit_now:
                stats_count = state.count
            else:
                # Mid-cycle rebuild after a resume: normalise with the stats
                # the uninterrupted run froze at its last refit round.
                t_last = (t // refit_every) * refit_every
                stats_count = state.count - (t - t_last) * batch_size
            y_stat = state.y_buf[:stats_count]
            ymean = float(y_stat.mean())
            ystd = float(y_stat.std()) + 1e-8
            if refit_now:
                mask_np[:] = 0.0
                mask_np[: state.count] = 1.0
                mask = torch.from_numpy(mask_np.copy()).to(dev)
                y_n = torch.from_numpy((state.y_buf - ymean) / ystd).to(dev) * mask
                trace_x = walks.sample_walks_for_nodes(
                    graph, torch.from_numpy(state.x_buf.copy()).to(dev),
                    walk_seed, walk.n_walkers, walk.p_halt, walk.l_max,
                    walk.reweight, walk.scheme,
                )
                (fit_strategy,) = _resolve_auto((fit_strategy,), trace_x, mod,
                                                state.params, mask, n)
                _refit(state, trace_x, mod, y_n, n, mask, seed, t,
                       refit_steps, noise_std, fit_strategy, dev)
            # One O(m³) Gram refactorisation into a fresh ServeState.
            serve = serving.init_state(
                graph, walk_seed, mod(state.params["mod"]),
                mll.noise_var(state.params), capacity, walk,
            )
            serve = serving.ingest(serve, state.x_obs, (y_live - ymean) / ystd)

        if n_candidates >= n:
            cand = np.arange(n, dtype=np.int32)
        else:
            # Seeded per (seed, t) so a resumed run draws the same
            # candidates at round t as the uninterrupted run.
            cand_rng = np.random.default_rng((cand_seed, t))
            cand = cand_rng.choice(n, size=n_candidates,
                                   replace=False).astype(np.int32)
        with obs.span("bo.draw", round=t, mode="joint"):
            # The copy to the host ends inside the span window.
            draws = serving.thompson_draw(
                serve, cand, _generator(seed, dev, _DRAW, t),
                n_samples=batch_size,
            ).cpu().numpy()                       # [q, batch_size]
        picks = _argmax_picks(draws, cand, np.isin(cand, state.x_obs),
                              batch_size)
        ys = np.asarray(objective(np.array(picks)), dtype=np.float32)
        serve = serving.observe_batch(serve, picks, (ys - ymean) / ystd)
        _record_round(state, picks, ys, f_max, checkpoint_cb, t)
    return state
