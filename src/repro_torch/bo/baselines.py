"""Uncertainty-free BO baselines (port of ``repro/bo/baselines.py``; paper
§4.3): random / BFS / DFS search.  numpy only; the graph's adjacency is
read back from its device once per run."""
from __future__ import annotations

from collections import deque

import numpy as np

from ..graphs.formats import Graph


def _run(order_iter, objective, n_init_obs, n_steps, f_max):
    regret, best = [], -np.inf
    for t, batch in enumerate(order_iter):
        y = objective(np.asarray(batch))
        best = max(best, float(np.max(y)))
        if t >= n_init_obs:
            regret.append(f_max - best)
        if len(regret) >= n_steps:
            break
    return regret


def random_search(graph: Graph, objective, key, n_init: int, n_steps: int,
                  f_max: float):
    rng = np.random.default_rng(key)
    perm = rng.permutation(graph.n_nodes)
    order = [perm[:n_init]] + [perm[n_init + t: n_init + t + 1]
                               for t in range(n_steps)]
    return _run(iter(order), objective, 1, n_steps, f_max)


def _neighbors_np(graph: Graph):
    return graph.neighbors.cpu().numpy(), graph.deg.cpu().numpy()


def bfs_search(graph: Graph, objective, key, n_init: int, n_steps: int,
               f_max: float):
    return _traversal(graph, objective, key, n_init, n_steps, f_max, dfs=False)


def dfs_search(graph: Graph, objective, key, n_init: int, n_steps: int,
               f_max: float):
    return _traversal(graph, objective, key, n_init, n_steps, f_max, dfs=True)


def _traversal(graph, objective, key, n_init, n_steps, f_max, dfs: bool):
    rng = np.random.default_rng(key)
    nbr, deg = _neighbors_np(graph)
    start = rng.integers(0, graph.n_nodes, size=max(n_init, 1))
    frontier = deque(int(s) for s in start)
    seen = set(frontier)

    def order():
        yield np.asarray(list(frontier))
        while frontier:
            v = frontier.pop() if dfs else frontier.popleft()
            for u in nbr[v, : deg[v]]:
                u = int(u)
                if u not in seen:
                    seen.add(u)
                    frontier.append(u)
                    yield np.array([u])

    return _run(order(), objective, 1, n_steps, f_max)
