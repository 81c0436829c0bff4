"""Carry the JAX package's state across to the port.

Takes the JAX package's objects as numpy arrays (``np.asarray`` of a jax
array works without importing JAX here) and builds the port's, on a given
device (default: the CUDA card).  The tests use it to feed both packages the
same graph, walk trace and hyperparameters, and the LM scaffold's parameters
and decode caches.
"""
from __future__ import annotations

import numpy as np
import torch

from . import device as _device
from .core.walks import WalkTrace
from .graphs.formats import Graph


def _tensor(a, dtype, dev) -> torch.Tensor:
    # Copy: arrays handed over from JAX are read-only views.
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(dev)


def graph_from_numpy(neighbors, weights, deg, device=None) -> Graph:
    """ELL ``Graph`` from the JAX ``Graph``'s three arrays."""
    dev = _device.resolve(device)
    return Graph(neighbors=_tensor(neighbors, np.int32, dev),
                 weights=_tensor(weights, np.float32, dev),
                 deg=_tensor(deg, np.int32, dev))


def trace_from_numpy(cols, loads, lens, device=None) -> WalkTrace:
    """``WalkTrace`` from the JAX trace's (cols, loads, lens)."""
    dev = _device.resolve(device)
    return WalkTrace(cols=_tensor(cols, np.int32, dev),
                     loads=_tensor(loads, np.float32, dev),
                     lens=_tensor(lens, np.int32, dev))


def params_from_numpy(params: dict, device=None) -> dict:
    """A nested dict of float32 parameters as tensors of the same layout:
    the hyperparameters of ``gp/mll.py::init_hyperparams`` (``{"mod":
    {...}, "log_sigma_n": ...}``), those of
    ``gp/exact.py::fit_exact_diffusion`` (``log_beta``, ``log_sigma_f``,
    ``log_sigma_n``) and the SVGP dict of ``gp/variational.py::init_svgp``
    (``mod``, ``mu``, ``log_scale_diag``, ``chol_lower``)."""
    dev = _device.resolve(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _tensor(x, np.float32, dev)

    return conv(params)


def _leaf(a, dtype, dev) -> torch.Tensor:
    """One array as a tensor; ``dtype`` None keeps the array's own, and a
    bfloat16 array (numpy has no such type of its own) crosses bit for bit."""
    a = np.asarray(a)
    if dtype is None and a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a.view(np.int16), order="C"))
        return bits.view(torch.bfloat16).to(dev)
    return _tensor(a, a.dtype if dtype is None else dtype, dev)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


def model_params_from_numpy(tree, device=None) -> dict:
    """The LM parameters of ``repro/models/model.py::init_params`` (a pytree
    of dicts and lists, leaves stacked per stage) as float32 tensors in the
    same layout, for ``repro_torch.models.model``."""
    dev = _device.resolve(device)
    return _tree(tree, lambda a: _leaf(a, np.float32, dev))


def cache_from_numpy(tree, device=None) -> dict:
    """A decode cache of the JAX model (``init_cache``/``prefill``) as
    tensors of the same dtypes (float32 or bfloat16), so that the port can
    continue a decode the JAX package started."""
    dev = _device.resolve(device)
    return _tree(tree, lambda a: _leaf(a, None, dev))
