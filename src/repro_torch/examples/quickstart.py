"""Quickstart on the PyTorch port: scalable GP regression on a graph with
GRFs, against the O(N³) exact GP.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The twin of examples/quickstart.py, with the same steps and flags
(``--scheme``, ``--skip-exact``) and ``--device`` (default: the CUDA card).
Builds a 20×20 grid graph, samples a ground-truth signal from an exact
diffusion GP, then runs the paper's three-step workflow (kernel
initialisation by random walks → LML hyperparameter learning →
pathwise-conditioned posterior) and compares it with the exact GP.
It materialises the full [N, K] walk trace; the chunked 10⁶-node path is
``posterior.pathwise_samples_chunked``.
"""
import argparse

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import features, kernels_exact, modulation, walks
from repro_torch.gp import exact, mll, posterior
from repro_torch.graphs import generators, signals
from repro_torch.kernels.walk_sampler.rng import SCHEMES

WALKS = dict(n_walkers=100, p_halt=0.1, l_max=10)
FIT = dict(steps=80, lr=0.08)
EXACT_STEPS = 150
N_SAMPLES = 64


def problem(dev, rows: int = 20, cols: int = 20, beta: float = 6.0):
    """(graph, ytrue [N], train, test, y [T]): a ground truth drawn from the
    exact diffusion kernel, a quarter of the nodes observed with noise 0.1
    (numpy ``default_rng(0)``)."""
    g = generators.grid2d(rows, cols, device=dev)
    n = g.n_nodes
    k_true = kernels_exact.diffusion_kernel(g, beta=beta)
    ytrue = signals.gp_sample_from_dense_kernel(k_true.cpu().numpy(), seed=0)
    rng = np.random.default_rng(0)
    train = rng.choice(n, n // 4, replace=False)
    y = (ytrue[train] + 0.1 * rng.standard_normal(len(train))).astype(np.float32)
    test = np.setdiff1d(np.arange(n), train)
    return g, ytrue, train, test, y


def scores(ytrue, test, mean, var):
    """(test RMSE, test NLPD) of a predictive mean and variance."""
    dev = mean.device
    yt = torch.as_tensor(np.asarray(ytrue, np.float32), device=dev)
    idx = torch.as_tensor(test, device=dev).long()
    return (float(posterior.rmse(yt[idx], mean[idx])),
            float(posterior.gaussian_nlpd(yt[idx], mean[idx], var[idx])))


def grf_gp(trace, train, y, ytrue, test, n_nodes: int, *, steps: int,
           lr: float, n_samples: int, l_max: int):
    """Steps 2–3 of the workflow on a walk trace: the LML fit (generator
    seed 1), then ``n_samples`` pathwise samples (seed 2).  Returns (fit,
    rmse, nlpd)."""
    dev = trace.cols.device
    mod = modulation.learnable(l_max=l_max)
    train_t = torch.as_tensor(train, device=dev)
    y_t = torch.as_tensor(y, device=dev)
    fit = mll.fit_hyperparams(
        features.take_rows(trace, train_t), mod, y_t, n_nodes,
        torch.Generator(device=dev).manual_seed(1), steps=steps, lr=lr,
    )
    f = mod(fit.params["mod"])
    s2 = mll.noise_var(fit.params)
    with torch.no_grad():
        samples = posterior.pathwise_samples(
            trace, train_t, f, s2, y_t,
            torch.Generator(device=dev).manual_seed(2), n_samples=n_samples,
        )
        mean, var = posterior.predictive_moments_from_samples(samples)
    return (fit, *scores(ytrue, test, mean, var + s2))


def exact_gp(graph, train, y, ytrue, test, steps: int = EXACT_STEPS):
    """The O(N³) baseline: the exact diffusion kernel's hyperparameters by
    full-LML ascent, then the Cholesky posterior.  Returns (params, rmse,
    nlpd)."""
    dev = graph.device
    train_t = torch.as_tensor(train, device=dev)
    y_t = torch.as_tensor(y, device=dev)
    params, k_full = exact.fit_exact_diffusion(graph, train_t, y_t,
                                               steps=steps)
    s2 = torch.exp(2 * params["log_sigma_n"])
    mean, var = exact.cholesky_posterior(k_full, train_t, y_t, s2)
    return (params, *scores(ytrue, test, mean, var + s2))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scheme", choices=SCHEMES, default="iid",
                        help="walker variance-reduction scheme")
    parser.add_argument("--skip-exact", action="store_true",
                        help="skip the O(N^3) exact-GP baseline")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    dev = _device.resolve(args.device)
    g, ytrue, train, test, y = problem(dev)
    n = g.n_nodes
    print(f"graph: {n} nodes; observations: {len(train)}")

    # --- 1) kernel initialisation: GRF random walks (Alg. 1) ---------------
    seed = walks.walk_seed(torch.Generator().manual_seed(0))
    tr = walks.sample_walks(g, seed, scheme=args.scheme, **WALKS)
    print(f"GRF trace [{args.scheme}]: {tr.slots} deposit slots/node "
          f"({tr.loads.numel() * 12 / 1e6:.1f} MB total, vs "
          f"{n * n * 4 / 1e6:.1f} MB dense)")

    # --- 2) hyperparameter learning, 3) pathwise posterior -----------------
    fit, rmse, nlpd = grf_gp(tr, train, y, ytrue, test, n,
                             n_samples=N_SAMPLES, l_max=WALKS["l_max"], **FIT)
    print("fit trace:", fit.history[-1])
    print(f"GRF-GP  : test RMSE {rmse:.4f}  NLPD {nlpd:.4f}")

    # --- exact O(N³) baseline ----------------------------------------------
    if args.skip_exact:
        return 0
    _, rmse_ex, nlpd_ex = exact_gp(g, train, y, ytrue, test)
    print(f"exact GP: test RMSE {rmse_ex:.4f}  NLPD {nlpd_ex:.4f}")
    return 0


if __name__ == "__main__":
    main()
