"""GRF random-walk sampling (paper Alg. 1/2) — port of ``repro/core/walks.py``.

Alg. 2's data-dependent ``while`` loop is fixed-length masked stepping: a
halted walker keeps moving with its deposits masked to zero, which leaves the
deposit distribution unchanged.  Sampling goes through
``kernels.dispatch.walk_sample`` (CUDA kernel on the card, plain version on
the CPU); its counter RNG is keyed on (seed, absolute start node, walker,
step), so sampling N nodes at once, in chunks, or a subset of rows yields the
same rows.

The walk RNG is keyed on a **uint32 seed** (a Python int), not on a PRNG
key: :func:`walk_seed` draws one from a ``torch.Generator``.  Each
sampling call is a ``walks.sample`` obs span, blocked on its trace; the
row, walker and call counters are kept by ``kernels.dispatch.walk_sample``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from .. import obs
from ..graphs.formats import Graph
from ..kernels import dispatch
from ..kernels.ell_spmv.index import ColumnIndex, column_index
from ..kernels.walk_sampler.rng import SCHEMES

DEFAULT_CHUNK = 65536


@dataclasses.dataclass(frozen=True)
class WalkTrace:
    """ELL-format walk deposits for a block of nodes.

    K = n_walkers * (l_max + 1) deposit slots per node.

    Attributes:
      cols:  int32[M, K] — deposit column (node where the prefix subwalk ends).
      loads: float32[M, K] — importance-sampling load, already divided by n;
             zero for masked (post-termination) deposits.
      lens:  int32[M, K] — prefix subwalk length l of each deposit.
    """

    cols: torch.Tensor
    loads: torch.Tensor
    lens: torch.Tensor

    @property
    def n_nodes(self) -> int:
        return self.cols.shape[0]

    @property
    def slots(self) -> int:
        return self.cols.shape[1]

    def column_index(self, n_nodes: int) -> ColumnIndex:
        """The fused K̂ kernel's index of this trace's non-zero slots over
        ``n_nodes`` graph nodes (kernels/ell_spmv/index.py), built on first
        use and kept on the trace: it depends on ``cols`` and on which
        ``loads`` are 0, not on the modulation, so every product with this
        trace — every CG iteration, fit step and later call — reads the same
        one.  The key holds the tensors' versions too, so an in-place write
        (a donated serving update writes its state's trace) rebuilds the
        index instead of reading a stale one.  A build is the
        ``walks.column_index`` span; a read of the kept index is none."""
        key = (n_nodes, self.cols._version, self.loads._version)
        kept = self.__dict__.get("_column_index")
        if kept is None or kept[0] != key:
            with obs.span("walks.column_index"):
                kept = (key, column_index(self.cols, self.loads, n_nodes))
            object.__setattr__(self, "_column_index", kept)
        return kept[1]


@dataclasses.dataclass(frozen=True)
class WalkConfig:
    """Walk-sampling hyperparameters; ``scheme`` is validated.

    ``scheme`` picks the walker variance-reduction strategy: "iid" |
    "antithetic" | "qmc" | "grfspp"."""

    n_walkers: int
    p_halt: float = 0.1
    l_max: int = 10
    reweight: bool = True
    scheme: str = "iid"

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(
                f"unknown walk scheme {self.scheme!r}; valid: {SCHEMES}"
            )

    @property
    def slots(self) -> int:
        return self.n_walkers * (self.l_max + 1)


def walk_seed(generator: torch.Generator) -> int:
    """Draw the uint32 counter-RNG seed from a ``torch.Generator``.

    Passing the same seed to ``sample_walks``, ``sample_walks_for_nodes`` or
    a chunked operator yields rows of the *same* underlying Φ."""
    return int(torch.randint(0, 2**32, (), generator=generator,
                             dtype=torch.int64, device=generator.device))


def _sample(graph: Graph, nodes: torch.Tensor, seed: int,
            cfg: WalkConfig) -> WalkTrace:
    cols, loads, lens = dispatch.walk_sample(
        graph.neighbors, graph.weights, graph.deg, nodes, seed,
        n_walkers=cfg.n_walkers, p_halt=cfg.p_halt, l_max=cfg.l_max,
        reweight=cfg.reweight, scheme=cfg.scheme,
    )
    return WalkTrace(cols=cols, loads=loads, lens=lens)


def sample_walks(
    graph: Graph,
    seed: int,
    n_walkers: int,
    p_halt: float = 0.1,
    l_max: int = 10,
    reweight: bool = True,
    scheme: str = "iid",
) -> WalkTrace:
    """Sample ``n_walkers`` truncated walks from every node (Alg. 2).

    Returns a :class:`WalkTrace` with K = n_walkers*(l_max+1) slots per node,
    on the graph's device."""
    cfg = WalkConfig(n_walkers, p_halt, l_max, reweight, scheme)
    nodes = torch.arange(graph.n_nodes, dtype=torch.int32, device=graph.device)
    with obs.span("walks.sample", rows=graph.n_nodes, scheme=scheme) as sp:
        trace = _sample(graph, nodes, seed, cfg)
        sp.block_on(trace)
    return trace


def sample_walks_for_nodes(
    graph: Graph,
    nodes: torch.Tensor,
    seed: int,
    n_walkers: int,
    p_halt: float = 0.1,
    l_max: int = 10,
    reweight: bool = True,
    scheme: str = "iid",
) -> WalkTrace:
    """Sample walks only from ``nodes``; the rows equal the corresponding rows
    of ``sample_walks(graph, seed, ...)`` exactly."""
    cfg = WalkConfig(n_walkers, p_halt, l_max, reweight, scheme)
    nodes = nodes.to(graph.device)
    if nodes.numel() and not (0 <= int(nodes.min()) and int(nodes.max()) < graph.n_nodes):
        raise ValueError(f"nodes must lie in [0, {graph.n_nodes})")
    with obs.span("walks.sample", rows=int(nodes.shape[0]),
                  scheme=scheme) as sp:
        trace = _sample(graph, nodes, seed, cfg)
        sp.block_on(trace)
    return trace


def walk_chunks(
    graph: Graph,
    seed: int,
    cfg: WalkConfig,
    chunk: int = DEFAULT_CHUNK,
) -> Iterator[tuple[int, WalkTrace]]:
    """Stream (row_start, WalkTrace) over node blocks of ``chunk`` rows.

    Peak memory is O(chunk · K) instead of O(N · K); concatenating every
    yielded trace reproduces ``sample_walks`` bit for bit."""
    n = graph.n_nodes
    for start in range(0, n, chunk):
        nodes = torch.arange(start, min(start + chunk, n), dtype=torch.int32,
                             device=graph.device)
        with obs.span("walks.sample", rows=int(nodes.shape[0]),
                      scheme=cfg.scheme, chunk_start=start) as sp:
            trace = _sample(graph, nodes, seed, cfg)
            sp.block_on(trace)
        yield start, trace
