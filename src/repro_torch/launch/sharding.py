"""Named sharding rules: DP / TP / EP / FSDP / ZeRO-1 / sequence-parallel
(port of ``repro/launch/sharding.py``).

Rules are *divisibility-safe*: for each tensor dim the rule proposes a mesh
axis and falls back to replication when the dim doesn't divide, so every
(arch × shape × mesh) cell gets a valid (if not always optimal) layout.

A spec is what JAX's ``PartitionSpec`` holds: a tuple with one entry per
tensor dim, each ``None``, a mesh-axis name, or a tuple of names (one
tensor dim split over several mesh axes, the first outermost).  Specs keep
the leaf-name table below readable against JAX's, leaf for leaf;
:func:`placements` turns one into the ``Shard``/``Replicate`` placements of
a DTensor on a ``DeviceMesh``.  A mesh here is a ``DeviceMesh`` with named
dims or any object with ``axis_names`` and a name → size ``shape`` (JAX's
``Mesh``/``AbstractMesh`` too: the parity tests pass those).

Leaf-name → layout table (core dims, before the stacked [repeat] axis that
all ``stages/...`` leaves carry):

  embed/unembed [V, D]        → (model, fsdp)
  wq [D,H,hd] wk/wv [D,Hkv,hd]→ (fsdp, model@heads | model@hd, ·)
  wo [H, hd, D]               → (model, ·, fsdp)
  gate/up [D, F]              → (fsdp, model)     down [F, D] → (model, fsdp)
  router [D, E]               → (fsdp, ·)
  w_gate/w_up [E, D, F]       → (model=EP, fsdp, ·)   w_down [E, F, D] → (model, ·, fsdp)
  mla: wq_a [D,rq]→(fsdp, model); wq_b [rq,H,·]→(·, model, ·);
       wkv_a [D, rk+rd]→(fsdp, ·); wk_b/wv_b [rk,H,hd]→(·, model, ·)
  mamba: in_proj [D, M]→(fsdp, model); conv_w [dk, C]→(·, model);
         out_proj [din, D]→(model, fsdp)
  norms / scalars             → replicated
"""
from __future__ import annotations

import math
from typing import Any

import torch

# ---------------------------------------------------------------------------
# Meshes: axis names and sizes of a DeviceMesh or a JAX-style mesh.
# ---------------------------------------------------------------------------


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size}: a DeviceMesh's ``shape`` is a tuple in dim order,
    a JAX mesh's a name → size mapping."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def data_axes(mesh) -> tuple:
    """Axes that carry the batch: ('pod', 'data') when a pod axis exists."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _entry(axes: tuple):
    """A spec entry for ``axes``: one name alone, as ``PartitionSpec``
    normalises a 1-tuple."""
    return axes[0] if len(axes) == 1 else axes


def placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements (one per mesh dim) of ``spec``: mesh dim ``a``
    shards the tensor dim whose entry names ``a``, else replicates.  A
    tensor dim named by several axes is split over them in mesh-dim order,
    which is the spec's order for every spec these rules make (pod before
    data)."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for dim, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                where[name] = dim
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in axis_names(mesh))


# ---------------------------------------------------------------------------
# Activation sharding constraints (sequence-parallel attention).  Models are
# mesh-agnostic; the launcher registers the active mesh and the layers call
# ``constrain`` with symbolic axes ("batch" → the data axes).  No-op when no
# mesh is registered (local tests, one device) or on a plain tensor.
# ---------------------------------------------------------------------------
_ACT_MESH = None


def set_activation_mesh(mesh) -> None:
    global _ACT_MESH
    _ACT_MESH = mesh


def get_activation_mesh():
    return _ACT_MESH


def constrain(x, *axes):
    """Redistribute the DTensor ``x`` to divisibility-safe symbolic axes.

    ``axes`` entries: None, a mesh-axis name, a tuple of names, or "batch"
    (resolves to the present data axes).  Axes that don't divide the dim are
    dropped rather than erroring."""
    from torch.distributed.tensor import DTensor

    mesh = _ACT_MESH
    if mesh is None or not isinstance(x, DTensor):
        return x
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    parts = []
    for dim, ax in zip(x.shape, axes):
        if ax == "batch":
            ax = data_axes(mesh)
        if ax is None:
            parts.append(None)
            continue
        group = ax if isinstance(ax, tuple) else (ax,)
        if not all(n in names for n in group):
            parts.append(None)
            continue
        total = math.prod(sizes[n] for n in group)
        parts.append(ax if total and dim % total == 0 else None)
    return x.redistribute(mesh, placements(tuple(parts), mesh))


# ---------------------------------------------------------------------------
# Parameter rules.
# ---------------------------------------------------------------------------

def _div(mesh, axis: str | None, dim: int) -> str | None:
    if axis is None or axis not in axis_names(mesh):
        return None
    return axis if dim % axis_sizes(mesh)[axis] == 0 else None


def param_spec(name: str, shape: tuple, mesh, *, fsdp: bool, stacked: bool) -> tuple:
    """The spec of one parameter leaf."""
    core = shape[1:] if stacked else shape
    f = "data" if fsdp else None

    def spec(*axes):
        axes = [_div(mesh, a, core[i]) if isinstance(a, str) else a
                for i, a in enumerate(axes)]
        if stacked:
            axes = [None] + axes
        return tuple(axes)

    if name in ("embed", "unembed"):
        return spec("model", f)
    if name in ("wq", "wk", "wv"):
        m1 = _div(mesh, "model", core[1])
        m2 = None if m1 else _div(mesh, "model", core[2])
        return spec(f, m1, m2)
    if name == "wo":
        m0 = _div(mesh, "model", core[0])
        return spec(m0, None if m0 else "model", f)
    if name in ("gate", "up", "shared_gate", "shared_up"):
        return spec(f, "model")
    if name in ("down", "shared_down"):
        return spec("model", f)
    if name in ("w_gate", "w_up"):
        return spec("model", f, None)
    if name == "w_down":
        return spec("model", None, f)
    if name in ("router", "wkv_a"):
        return spec(f, None)
    if name in ("wq_a", "in_proj"):
        return spec(f, "model")
    if name in ("wq_b", "wk_b", "wv_b"):
        return spec(None, "model", None)
    if name == "conv_w":
        return spec(None, "model")
    if name == "out_proj":
        return spec("model", f)
    # norms, biases, scalars (a_log, d_skip, dt_bias, conv_b, q_norm, ...)
    return spec(*([None] * len(core)))


def map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *other leaves)`` over nested dicts/lists (a tuple is
    a leaf: specs are tuples); ``path`` holds the dict keys and list
    indices as strings, as JAX's key paths print them."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], *(r[k] for r in rest), path=path + (str(k),))
                for k in tree}
    if isinstance(tree, list):
        return [map_with_path(fn, t, *(r[i] for r in rest), path=path + (str(i),))
                for i, t in enumerate(tree)]
    return fn(path, tree, *rest)


def _leaf_specs(params: Any, mesh, fsdp: bool) -> Any:
    def rule(keys, leaf):
        # Leaves under stages/ carry the [repeat] axis; shared, top-level
        # and the encoder's final norm do not.
        stacked = "stages" in keys and keys[0] not in (
            "embed", "unembed", "final_norm", "shared")
        return param_spec(keys[-1], tuple(leaf.shape), mesh, fsdp=fsdp,
                          stacked=stacked)

    return map_with_path(rule, params)


def param_specs(params: Any, mesh, cfg) -> Any:
    return _leaf_specs(params, mesh, cfg.fsdp)


def param_shardings(params: Any, mesh, cfg) -> Any:
    """The placements of every parameter leaf."""
    return map_with_path(lambda _, s: placements(s, mesh),
                         param_specs(params, mesh, cfg))


def opt_specs(params: Any, mesh, cfg) -> Any:
    """μ/ν specs: follow params; ZeRO-1 additionally shards the leading
    (stacked-layer) axis over ``data`` when the param itself is not
    data-sharded — optimizer state is elementwise, so any extra axis works."""
    specs = _leaf_specs(params, mesh, cfg.fsdp)
    n_data = axis_sizes(mesh).get("data", 1)

    def zero1(_, spec, leaf):
        if cfg.fsdp or not cfg.zero1 or "data" in spec:
            return spec
        if leaf.dim() >= 1 and spec and spec[0] is None and leaf.shape[0] % n_data == 0:
            return ("data",) + spec[1:]
        return spec

    return map_with_path(zero1, specs, params)


def opt_shardings(params: Any, mesh, cfg) -> Any:
    return map_with_path(lambda _, s: placements(s, mesh),
                         opt_specs(params, mesh, cfg))


def batch_spec(mesh, global_batch: int, ndim: int) -> tuple:
    """Shard the batch dim over (pod, data) when divisible."""
    axes = data_axes(mesh)
    sizes = axis_sizes(mesh)
    total = math.prod(sizes[a] for a in axes) if axes else 1
    lead = _entry(axes) if axes and global_batch % total == 0 else None
    return (lead,) + (None,) * (ndim - 1)


def cache_entry_spec(name: str, shape: tuple, mesh) -> tuple:
    """Decode-cache spec.  Batch over (pod, data) when divisible; else
    sequence-parallel: shard the sequence dim over data (long_500k, B=1)."""
    axes = data_axes(mesh)
    sizes = axis_sizes(mesh)
    total = math.prod(sizes[a] for a in axes) if axes else 1
    n_data, n_model = sizes.get("data", 1), sizes.get("model", 1)
    # shapes (after the stacked [repeat] axis): k/v [B,Hkv,S,hd],
    # c_kv [B,S,rk], k_rope [B,S,rd], conv [B,dk,C], ssm [B,H,n,p]
    core = shape[1:]
    parts: list = [None] * len(core)
    if core[0] % total == 0 and total > 1:
        parts[0] = _entry(axes)
    elif name in ("k", "v") and len(core) == 4:
        if core[2] % n_data == 0:
            parts[2] = "data"
        if core[1] % n_model == 0:
            parts[1] = "model"
    elif name in ("c_kv", "k_rope") and len(core) == 3:
        if core[1] % n_data == 0:
            parts[1] = "data"
    elif name == "ssm" and len(core) == 4:
        if core[1] % n_data == 0:
            parts[1] = "data"
    elif name == "conv" and len(core) == 3:
        if core[2] % n_model == 0:
            parts[2] = "model"
    # model-axis sharding of kv heads for batch-sharded attention caches
    if parts[0] is not None and name in ("k", "v") and len(core) == 4:
        if core[1] % n_model == 0:
            parts[1] = "model"
    return (None, *parts)  # leading stacked [repeat] axis replicated


def cache_specs(cache: Any, mesh) -> Any:
    return map_with_path(
        lambda keys, leaf: cache_entry_spec(keys[-1], tuple(leaf.shape), mesh), cache)


def cache_shardings(cache: Any, mesh) -> Any:
    return map_with_path(lambda _, s: placements(s, mesh), cache_specs(cache, mesh))


# ---------------------------------------------------------------------------
# Placing trees.
# ---------------------------------------------------------------------------

def distribute(tree: Any, mesh, shardings: Any) -> Any:
    """Every leaf of ``tree`` as a DTensor with its placements (each rank
    keeps its own shard of the full tensor it holds)."""
    from torch.distributed.tensor import distribute_tensor

    return map_with_path(
        lambda _, t, pl: distribute_tensor(t.detach(), mesh, pl), tree, shardings)


def to_full(tree: Any) -> Any:
    """Every DTensor leaf gathered into a plain tensor on every rank."""
    from torch.distributed.tensor import DTensor

    return map_with_path(
        lambda _, t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def spmd(tree: Any):
    """The context a step over ``tree`` runs in: when any leaf is a DTensor,
    plain tensors the model makes (positions, masks, rotary tables) count
    as replicated on its mesh; otherwise nothing."""
    import contextlib

    from torch.distributed.tensor import DTensor

    leaves = []
    map_with_path(lambda _, t: leaves.append(t), tree)
    if any(isinstance(t, DTensor) for t in leaves):
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()
    return contextlib.nullcontext()
