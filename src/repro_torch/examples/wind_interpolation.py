"""Wind-speed interpolation on the sphere (paper §4.2, ERA5 stand-in) on the
PyTorch port: implicit manifold GP regression via a kNN graph + GRF
kernels.

    PYTHONPATH=src python -m repro_torch.examples.wind_interpolation --nodes 2000

The twin of examples/wind_interpolation.py, with the same flags and
``--device`` (default: the CUDA card).  Observations lie on a
satellite-track-like band; both a diffusion-shaped and a fully-learnable
modulation are fitted and scored on the held-out nodes.
"""
import argparse

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import features, modulation, walks
from repro_torch.gp import mll, posterior
from repro_torch.graphs import generators, signals


def problem(n_nodes: int, dev):
    """(graph, wind [N], train, test, y [T]): the kNN sphere graph, its wind
    field and the track observations with noise 0.05."""
    g, xyz = generators.knn_sphere(n_nodes, k=6, seed=0, device=dev)
    wind = signals.wind_field_sphere(xyz, seed=0)
    n = g.n_nodes
    rng = np.random.default_rng(0)
    lon = np.arctan2(xyz[:, 1], xyz[:, 0])
    lat = np.arcsin(np.clip(xyz[:, 2], -1, 1))
    track = np.abs(np.sin(3 * lon) * 0.8 - np.sin(lat)) < 0.15
    train = np.where(track)[0]
    if len(train) < 30:
        train = rng.choice(n, n // 5, replace=False)
    test = np.setdiff1d(np.arange(n), train)
    y = (wind[train] + 0.05 * rng.standard_normal(len(train))).astype(np.float32)
    return g, wind, train, test, y


def run(args) -> dict[str, tuple[float, float]]:
    """Fit and score both modulations; returns {name: (rmse, nlpd)}."""
    dev = _device.resolve(args.device)
    g, wind, train, test, y = problem(args.nodes, dev)
    n = g.n_nodes
    print(f"sphere kNN graph: {n} nodes; track observations: {len(train)}")
    tr = walks.sample_walks(g, walks.walk_seed(torch.Generator().manual_seed(0)),
                            n_walkers=args.walkers, p_halt=0.1, l_max=8)
    train_t = torch.as_tensor(train, device=dev)
    y_t = torch.as_tensor(y, device=dev)
    wind_t = torch.as_tensor(wind, dtype=torch.float32, device=dev)
    test_t = torch.as_tensor(test, device=dev)
    out = {}
    for name, mod in (("diffusion-shape", modulation.diffusion(l_max=8)),
                      ("fully-learnable", modulation.learnable(l_max=8))):
        fit = mll.fit_hyperparams(
            features.take_rows(tr, train_t), mod, y_t, n,
            torch.Generator(device=dev).manual_seed(1), steps=80, lr=0.08,
        )
        f = mod(fit.params["mod"])
        s2 = mll.noise_var(fit.params)
        with torch.no_grad():
            samples = posterior.pathwise_samples(
                tr, train_t, f, s2, y_t,
                torch.Generator(device=dev).manual_seed(2), n_samples=64)
            m, v = posterior.predictive_moments_from_samples(samples)
            rmse = float(posterior.rmse(wind_t[test_t], m[test_t]))
            nlpd = float(posterior.gaussian_nlpd(wind_t[test_t], m[test_t],
                                                 v[test_t] + s2))
        out[name] = (rmse, nlpd)
        print(f"{name:16s}: test RMSE {rmse:.4f}  NLPD {nlpd:.4f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--walkers", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
