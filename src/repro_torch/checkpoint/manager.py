"""Fault-tolerant checkpointing (port of ``repro/checkpoint/manager.py``).

Step-tagged directories with atomic commit (write tmp → fsync → rename), a
``MANIFEST.json`` for integrity, an async save thread, keep-N GC, and a
restore that puts each leaf back on the device and dtype of the example
tree's leaf.  Interrupted saves are never visible (no MANIFEST ⇒ ignored,
and their ``.tmp`` directories are removed).

The files are the JAX package's: ``step_%010d/arrays.npz`` keyed by the
leaf paths JAX's ``tree_flatten_with_path`` gives (a dict key, a sequence
index, a ``WalkTrace`` field's position, a NamedTuple field's name, joined
by ``/``; dict keys sorted), and ``MANIFEST.json`` with ``step``, ``time``,
``keys`` and ``extra``.  A checkpoint either package writes restores in the
other.  The trees handled are those of the port: tuples, lists, dicts,
NamedTuples, :class:`~repro_torch.core.walks.WalkTrace`, tensors, numpy
arrays and Python scalars (None is an empty subtree).  Tensors are copied
to host numpy on the caller's thread, before the async writer starts: the
writer never touches a CUDA tensor.  numpy has no bfloat16, so a bf16 leaf
raises a TypeError naming it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch

from ..core.walks import WalkTrace

_SCALARS = (bool, int, float)


def _node(tree: Any):
    """(keys, children, rebuild) of a tree node, children in JAX's order
    (dict keys sorted), or None for a leaf."""
    if isinstance(tree, dict):
        # Keys in JAX's (sorted) order; a rebuilt dict keeps the example's
        # own order, so that a restored tree's leaves come in the order of
        # the tree it replaces (the global norm sums them in that order).
        keys = sorted(tree)

        def rebuild(kids):
            by_key = dict(zip(keys, kids))
            return {k: by_key[k] for k in tree}

        return [str(k) for k in keys], [tree[k] for k in keys], rebuild
    if isinstance(tree, WalkTrace):
        return (["0", "1", "2"], [tree.cols, tree.loads, tree.lens],
                lambda kids: WalkTrace(*kids))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(tree._fields), list(tree), lambda kids: type(tree)(*kids)
    if isinstance(tree, (tuple, list)):
        return ([str(i) for i in range(len(tree))], list(tree),
                lambda kids: type(tree)(kids))
    return None


def _leaves(tree: Any, path: tuple = ()) -> Iterator[tuple[str, Any]]:
    if tree is None:
        return
    node = _node(tree)
    if node is None:
        yield "/".join(path), tree
        return
    for key, child in zip(*node[:2]):
        yield from _leaves(child, path + (key,))


def _numpy_dtype(key: str, dtype: torch.dtype) -> np.dtype:
    if dtype == torch.bfloat16:
        raise TypeError(
            f"checkpoint leaf {key!r} is bfloat16, which numpy (and so the "
            "npz format) cannot hold")
    return torch.empty((), dtype=dtype).numpy().dtype


def _to_host(key: str, leaf: Any) -> np.ndarray:
    """A private host copy of ``leaf`` (later writes to it do not reach
    the checkpoint)."""
    if isinstance(leaf, torch.Tensor):
        _numpy_dtype(key, leaf.dtype)
        return np.array(leaf.detach().cpu().numpy())
    if isinstance(leaf, (np.ndarray, np.generic) + _SCALARS):
        return np.array(leaf)
    raise TypeError(f"checkpoint leaf {key!r} has unsupported type "
                    f"{type(leaf).__name__}")


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {key: _to_host(key, leaf) for key, leaf in _leaves(tree)}


def _restore_leaf(key: str, arr: np.ndarray, leaf: Any) -> Any:
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
    if tuple(arr.shape) != shape:
        raise ValueError(
            f"shape mismatch for {key}: ckpt {arr.shape} vs model {shape}")
    if isinstance(leaf, torch.Tensor):
        host = arr.astype(_numpy_dtype(key, leaf.dtype))
        return torch.from_numpy(host).to(leaf.device)
    if isinstance(leaf, _SCALARS):
        return type(leaf)(arr.item())
    return arr.astype(leaf.dtype)


def _unflatten_like(tree: Any, flat: dict[str, np.ndarray],
                    path: tuple = ()) -> Any:
    if tree is None:
        return None
    node = _node(tree)
    if node is None:
        key = "/".join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        return _restore_leaf(key, flat[key], tree)
    keys, kids, rebuild = node
    return rebuild([_unflatten_like(child, flat, path + (key,))
                    for key, child in zip(keys, kids)])


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            p = os.path.join(self.dir, name)
            if name.startswith("step_") and os.path.exists(
                os.path.join(p, "MANIFEST.json")
            ):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True,
             extra: dict | None = None):
        flat = _flatten(tree)  # host copies happen on the caller thread

        def _write():
            final = self._step_dir(step)
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            manifest = {
                "step": step,
                "time": time.time(),
                "keys": sorted(flat),
                "extra": extra or {},
            }
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            _write()
        else:
            self.wait()
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        # drop orphaned tmp dirs (interrupted saves)
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, example: Any, step: int | None = None) -> tuple[Any, dict]:
        """(tree like ``example``, manifest) of ``step`` (default: the
        latest).  Each leaf comes back on the example leaf's device and in
        its dtype; a shape that differs raises ValueError, a missing leaf
        KeyError."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        return _unflatten_like(example, flat), manifest
