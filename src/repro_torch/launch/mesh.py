"""The serving mesh over ``torch.distributed`` (port of
``repro/launch/mesh.py::make_serving_mesh``).

JAX's ``shard_map`` is SPMD within one process over a device mesh; the
PyTorch idiom is one process per rank.  :func:`make_serving_mesh` therefore
returns a small :class:`ServingMesh` over a process group — the group, its
size and this process's rank, with the one axis ``"data"`` — and the
sharded functions (``distributed/gp_shard.py``, ``serving/sharded.py``)
take it where JAX takes a ``Mesh``: each rank works on its own row range
``[rank·N/P, (rank+1)·N/P)``, as ``P("data")`` places it.

Nothing here starts a process group on its own: the caller runs
``torch.distributed.init_process_group`` in every rank with an explicit
init method, world size and rank (gloo on the CPU; NCCL on the card, where
two ranks cannot share one device, so one card runs world size 1).
:func:`spawn_ranks` does exactly that for a function run in ``n`` spawned
processes, with a timeout that fails a hung collective.

The LM's meshes are ``torch.distributed`` ``DeviceMesh``es with named
dims, over the default process group: :func:`make_production_mesh` (the
JAX package's shapes, so that the spec tables compare leaf by leaf) and
:func:`make_host_mesh` (the ranks that exist).  The dry run supplies a fake
group of 256 or 512 ranks to the production mesh.
"""
from __future__ import annotations

import dataclasses
import datetime
import time

import torch.distributed as dist

from .sharding import data_axes  # noqa: F401  (JAX keeps it here)


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """A 1-D ``("data",)`` mesh: a process group, its size and this rank."""

    group: object
    size: int
    rank: int
    axis_names: tuple = ("data",)

    @property
    def shape(self) -> dict:
        return {"data": self.size}

    def rows(self, n: int) -> slice:
        """This rank's block of ``n`` rows; ``n`` must divide evenly."""
        if n % self.size:
            raise ValueError(f"{n} rows do not divide evenly across "
                             f"{self.size} shards")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def make_serving_mesh(n_shards: int | None = None) -> ServingMesh | None:
    """The ``("data",)`` mesh over the first ``n_shards`` ranks of the
    default process group (all of them by default).

    A smaller mesh is a new subgroup, which every rank of the default group
    must create together (``torch.distributed.new_group``'s rule): ranks
    outside it get ``None``.  Raises when no process group is initialised
    or when more shards are asked for than there are ranks."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_serving_mesh needs torch.distributed: call "
            "init_process_group(backend, init_method=..., world_size=..., "
            "rank=...) in every rank first (see spawn_ranks)"
        )
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n_shards or world
    if n > world:
        raise ValueError(f"requested {n} serving shards but the process "
                         f"group has {world} ranks")
    if n == world:
        return ServingMesh(dist.group.WORLD, n, rank)
    group = dist.new_group(list(range(n)))
    return ServingMesh(group, n, rank) if rank < n else None


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16×16 ranks per pod; 2 pods when ``multi_pod``.

    Axes: ``pod`` (inter-pod DP), ``data`` (intra-pod DP / FSDP / ZeRO-1 /
    sequence-parallel KV), ``model`` (TP / EP).  The default process group
    must have 256 (512) ranks.  On H100s, whose NVLink domain is an 8-GPU
    node, a 16-wide ``model`` axis spans two nodes, and so does ``data``:
    their collectives cross the nodes' network."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(n_data: int | None = None, n_model: int = 1,
                   device_type: str = "cuda"):
    """A (data, model) mesh over the ranks of the default process group."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    n_data = n_data or (n // n_model)
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def _rank_main(rank, fn, n, backend, init_method, timeout_s, args):
    dist.init_process_group(
        backend, init_method=init_method, world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, n: int, *, init_method: str, backend: str = "gloo",
                timeout_s: float = 120.0, args: tuple = ()) -> None:
    """Run ``fn(rank, *args)`` in ``n`` spawned processes (start method
    ``spawn``, never a fork), each inside its own process group of ``n``
    ranks joined at ``init_method`` (``file://...`` or
    ``tcp://localhost:<port>``).  ``fn`` must be importable by name.

    A rank that raises fails the call with its traceback; a run still going
    after ``timeout_s`` seconds (a hung collective) is killed and raises
    TimeoutError.  Every collective inside has the same timeout."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        _rank_main, args=(fn, n, backend, init_method, timeout_s, args),
        nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.05, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{n} ranks of {fn.__name__} still running "
                                   f"after {timeout_s:g} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()

