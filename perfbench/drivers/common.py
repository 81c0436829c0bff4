"""What the drivers share: the configuration's graph and signal, handed to
the program and to the reference alike, and the problem's sizes that the
work counts read."""
from __future__ import annotations

import functools
import hashlib
import json
import math
import os
from pathlib import Path

import numpy as np
import torch

from perfbench.graphs import generators

# Built graphs, kept inside the checkout at a fixed path and keyed by the
# hash of the configuration's ``graph`` entry: a graph does not depend on
# the run's seed, so only a checkout's first run builds it.
GRAPH_CACHE = Path(__file__).resolve().parents[2] / "build" / "perfbench" / "graphs"
GRAPH_KEYS = ("neighbors", "weights", "deg", "xyz")


def _build_graph(g: dict):
    if g["kind"] == "ring":
        return (*generators.ring(g["n_nodes"], g["k"]), None)
    if g["kind"] == "knn_sphere":
        arrays, xyz = generators.knn_sphere(g["n_nodes"], g["k"], g["seed"])
        return (*arrays, xyz)
    raise ValueError(f"unknown graph kind {g['kind']!r}")


@functools.lru_cache(maxsize=2)
def _host_graph(graph_json: str, cache: Path | None = GRAPH_CACHE):
    """(neighbors, weights, deg, xyz or None) of a configuration's graph,
    from the cache when a run of this checkout built it before."""
    name = hashlib.sha256(graph_json.encode()).hexdigest()[:24] + ".npz"
    path = None if cache is None else cache / name
    if path is not None and path.is_file():
        with np.load(path) as z:
            return tuple(z[k] if k in z else None for k in GRAPH_KEYS)
    arrays = _build_graph(json.loads(graph_json))
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        part = path.with_suffix(".part.npz")
        np.savez(part, **{k: a for k, a in zip(GRAPH_KEYS, arrays)
                          if a is not None})
        os.replace(part, path)
    return arrays


def host_graph(config: dict, cache: Path | None = GRAPH_CACHE):
    return _host_graph(json.dumps(config["graph"], sort_keys=True), cache)


def graph(config: dict, device):
    """The program's ``Graph`` of the configuration's arrays on ``device``."""
    from repro_torch.graphs.formats import Graph

    nb, w, deg, _ = host_graph(config)
    return Graph(torch.from_numpy(nb).to(device),
                 torch.from_numpy(w).to(device),
                 torch.from_numpy(deg).to(device))


def signal(config: dict, n: int) -> np.ndarray:
    """The configuration's true field over its n nodes."""
    s = config["signal"]
    if s["kind"] == "smooth_periodic_ring":
        return generators.smooth_periodic_ring(n, seed=s["seed"])
    if s["kind"] == "wind_field_sphere":
        return generators.wind_field_sphere(host_graph(config)[3], seed=s["seed"])
    raise ValueError(f"unknown signal kind {s['kind']!r}")


def observed(config: dict) -> np.ndarray:
    """The configuration's fixed observed nodes (the track rule)."""
    o = config["observations"]
    if o["kind"] == "track":
        return generators.track_nodes(host_graph(config)[3], o["amp"],
                                      o["freq"], o["width"]).astype(np.int32)
    raise ValueError(f"unknown observation kind {o['kind']!r}")


def observations(config: dict, traffic: dict, rng, n: int):
    """The observed nodes, ``traffic["observed"]`` of them drawn from
    ``rng`` or the configuration's own rule (``"config"``), and their
    values: the true field plus the configuration's noise from ``rng``."""
    if traffic["observed"] == "config":
        train = observed(config)
    else:
        train = np.sort(rng.choice(n, int(traffic["observed"]),
                                   replace=False)).astype(np.int32)
    y = (signal(config, n)[train] + config["noise_std"]
         * rng.standard_normal(len(train))).astype(np.float32)
    return train, y


def theta(config: dict, device, dtype=torch.float64) -> dict:
    """The configuration's hyperparameters as log scalars: the diffusion
    modulation's ``log_beta`` and ``log_sigma_f``, and ``log_sigma_n``
    (half the log of the noise variance ``sigma_n2``)."""
    h = config["hyperparams"]
    logs = {"log_beta": math.log(h["beta"]),
            "log_sigma_f": math.log(h["sigma_f"]),
            "log_sigma_n": 0.5 * math.log(h["sigma_n2"])}
    return {k: torch.tensor(v, dtype=dtype, device=device)
            for k, v in logs.items()}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def trace_problem(cols, loads, rows) -> dict:
    """Sizes of a trace that the work counts read: the non-zero slots of the
    whole trace and of its ``rows``, the distinct columns each touches, and
    the whole trace's slots that land on a column its ``rows`` touch."""
    live = loads != 0
    full_cols = cols[live].long()
    r = rows.long()
    x_cols = cols[r][live[r]].long()
    n = int(cols.shape[0])
    hit = torch.zeros(n, dtype=torch.bool, device=cols.device)
    hit[x_cols] = True
    return {"k": int(cols.shape[1]),
            "nnz": int(full_cols.numel()),
            "touched": int(torch.unique(full_cols).numel()),
            "nnz_x": int(x_cols.numel()),
            "touched_x": int(torch.unique(x_cols).numel()),
            "hits_x": int(hit[full_cols].sum())}
