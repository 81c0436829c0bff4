"""Per-device cost accounting of a traced step, with roofline terms (the
port's counterpart of ``repro/launch/hlo_analysis.py``, whose name it
keeps).

JAX compiles the step and reads XLA's ``cost_analysis`` and the collectives
of the post-SPMD HLO.  PyTorch has no compiled program to parse: this module
counts what PyTorch runs while the step is traced.  :class:`CostMode` is a
dispatch mode that lets every DTensor op desugar first (it returns
``NotImplemented`` to them, as ``CommDebugMode`` does) and then sees each
rank-local op DTensor issues — the local matmuls at their *local* shapes and
the collectives DTensor inserts, with their sizes and group sizes — so every
count below is **per device** (a matmul on a (4, 2) mesh sharded on both
dims counts global/8).  DTensor's sharding propagation also runs each new
op once on fake tensors of the *global* shapes; those are not device work
and are skipped (any op that touches a ``FakeTensor``).

Counts:
  flops           2·M·N·K of every matmul, convolution and attention op
                  (``torch.utils.flop_counter``'s formulas); elementwise ops
                  count 0, where XLA counts them too.  The record keeps the
                  12 largest (op, local input shapes) terms.
  bytes accessed  each op's tensor inputs read once and outputs written once;
                  views, allocations and collectives count 0.
  memory          argument / output bytes: the local shards exactly; temp:
                  the peak of live bytes of the tensors the step's ops
                  created; alias: outputs that are argument tensors (the
                  in-place train step's state).
  collectives     JAX's ring-model wire factors on each collective's bytes
                  (all-reduce: the reduced size; all-gather: the gathered
                  output; reduce-scatter: the scattered output shard;
                  all-to-all: the output).

Terms (seconds), per device: compute = flops / PEAK_FLOPS, memory = bytes /
HBM_BW, collective = wire bytes / LINK_BW.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# One H100 SXM: bf16 dense tensor-core peak, HBM3 bandwidth (NVIDIA H100
# data sheet), and the link rate a GPU has across nodes: one 400 Gb/s NDR
# InfiniBand NIC per GPU (DGX H100).  Every 16-wide axis of the production
# mesh spans two 8-GPU NVLink nodes, so its collectives run at the NIC rate.
PEAK_FLOPS = 989e12     # bf16 FLOP/s per GPU
HBM_BW = 3.35e12        # B/s per GPU
LINK_BW = 50e9          # B/s per GPU across nodes

_WIRE_FACTOR = {
    "all-reduce": lambda a: 2.0 * (a - 1) / a,
    "all-gather": lambda a: (a - 1) / a,
    "reduce-scatter": lambda a: float(a - 1),
    "all-to-all": lambda a: (a - 1) / a,
    "collective-permute": lambda a: 1.0,
}

# Collective ops → (JAX's collective type, which tensors carry its size:
# the outputs, or for an in-place all-reduce the inputs).
_COLLECTIVES = {
    "_c10d_functional.all_reduce": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "out"),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "out"),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter", "out"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "out"),
    "_c10d_functional_autograd.all_to_all_single": ("all-to-all", "out"),
    "c10d.allreduce_": ("all-reduce", "arg0"),
    "c10d.allreduce_coalesced_": ("all-reduce", "arg0"),
    "c10d.allgather_": ("all-gather", "arg0"),
    "c10d._allgather_base_": ("all-gather", "arg0"),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", "arg0"),
    "c10d.reduce_scatter_": ("reduce-scatter", "arg0"),
    "c10d._reduce_scatter_base_": ("reduce-scatter", "arg0"),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", "arg0"),
    "c10d.alltoall_": ("all-to-all", "arg0"),
    "c10d.alltoall_base_": ("all-to-all", "arg0"),
}
_NO_ACCESS = ("aten.empty", "aten.empty_strided", "aten.empty_like",
              "_c10d_functional.wait_tensor")


def _tensors(tree) -> list:
    """The tensors of a nest of dicts, lists, tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree) for t in _tensors(getattr(tree, f.name))]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` on one device (a DTensor's shard)."""
    return sum(_nbytes(_local(t)) for t in _tensors(tree))


def _group_size(func, args) -> int:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, torch.ScriptObject):   # c10d ops box their group
            return dist.ProcessGroup.unbox(a).size()
    for a in reversed(args):   # funcol ops end in their group's name
        if isinstance(a, str):
            return _resolve_process_group(a).size()
    raise ValueError(f"no process group in the arguments of {func}")


class CostMode(TorchDispatchMode):
    """Counts per-device FLOPs, bytes, collectives and live memory of the
    rank-local ops run inside it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: list = []   # (type, bytes, group size)
        self.flops_by_op: dict = {}   # "op [input shapes]" → FLOPs
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # let DTensor desugar into local ops first
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out              # sharding propagation at global shapes
        name = str(func.overloadpacket)
        if name in _COLLECTIVES:
            kind, where = _COLLECTIVES[name]
            size = sum(_nbytes(t) for t in (outs if where == "out" else _tensors(args[0])))
            self.collectives.append((kind, size, _group_size(func, args)))
            return out
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.flops += n
            key = f"{name} " + " ".join(str(list(t.shape)) for t in ins)
            self.flops_by_op[key] = self.flops_by_op.get(key, 0) + n
        if func.is_view or name in _NO_ACCESS:
            new = [] if func.is_view else outs
        else:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
            new = [t for t in outs if not any(t is i for i in ins)]
        for t in new:
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def collective_stats(records: list) -> dict:
    """Per-collective byte totals from (type, bytes, group size) records;
    a group of one moves nothing."""
    per_type_bytes: dict[str, float] = {}
    per_type_wire: dict[str, float] = {}
    count = 0
    for op, size, a in records:
        if a <= 1:
            continue
        per_type_bytes[op] = per_type_bytes.get(op, 0.0) + size
        per_type_wire[op] = per_type_wire.get(op, 0.0) + _WIRE_FACTOR[op](a) * size
        count += 1
    return {
        "n_collectives": count,
        "bytes_by_type": per_type_bytes,
        "wire_bytes_by_type": per_type_wire,
        "total_bytes": sum(per_type_bytes.values()),
        "total_wire_bytes": sum(per_type_wire.values()),
    }


def roofline_terms(cost: dict, colls: dict) -> dict:
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    wire = float(colls["total_wire_bytes"])
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_acc / HBM_BW
    t_coll = wire / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "bound_s": bound,
        "flops_per_device": flops,
        "bytes_per_device": bytes_acc,
        "wire_bytes_per_device": wire,
    }


def summarize(fn, args: tuple) -> dict:
    """Run ``fn(*args)`` once under :class:`CostMode` (plain tensors mixed
    with DTensors count as replicated) and return JAX's record: ``cost``,
    ``memory``, ``collectives`` and ``roofline``, all per device."""
    from torch.distributed.tensor.experimental import implicit_replication

    arg_ids = {id(_local(t)) for t in _tensors(args)}
    with implicit_replication(), CostMode() as mode:
        out = fn(*args)
    outs = [_local(t) for t in _tensors(out)]
    cost = {"flops": float(mode.flops), "bytes accessed": float(mode.bytes)}
    colls = collective_stats(mode.collectives)
    top = sorted(mode.flops_by_op.items(), key=lambda kv: -kv[1])[:12]
    return {
        "cost": cost,
        "flops_by_op": dict(top),
        "memory": {
            "argument_bytes": local_bytes(args),
            "output_bytes": sum(_nbytes(t) for t in outs),
            "temp_bytes": mode.peak,
            "alias_bytes": sum(_nbytes(t) for t in outs if id(t) in arg_ids),
        },
        "collectives": colls,
        "roofline": roofline_terms(cost, colls),
    }
