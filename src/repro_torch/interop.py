"""Carry the JAX package's state across to the port.

Takes the JAX package's objects as numpy arrays (``np.asarray`` of a jax
array works without importing JAX here) and builds the port's, on a given
device (default: the CUDA card).  The tests use it to feed both packages the
same graph, walk trace and hyperparameters.
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
    """The nested hyperparameter dict of ``gp/mll.py::init_hyperparams``
    (``{"mod": {...}, "log_sigma_n": ...}``) as float32 tensors."""
    dev = _device.resolve(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _tensor(x, np.float32, dev)

    return conv(params)
