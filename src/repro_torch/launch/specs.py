"""Input specs for every (arch × shape) dry-run cell (port of
``repro/launch/specs.py``).

JAX attaches shardings to ShapeDtypeStructs; here every input is a DTensor
on the mesh whose local shard lives on the ``meta`` device: it carries its
global shape, dtype and placements and allocates nothing.  Parameter
shapes come from the port's own ``init_params`` run on ``meta``.  Each
``build_*`` returns ``(fn, args)``: ``fn(*args)`` is the cell's step.
Frontend stubs as in JAX: whisper gets precomputed frame embeddings,
llama-vision patch embeddings."""
from __future__ import annotations

import torch

from ..models import model
from ..models.config import SHAPES, ModelConfig
from ..optim.adamw import AdamState, AdamW
from . import sharding as shr
from .train import TrainState, make_train_step


def fake(shape, dtype, mesh, spec: tuple):
    """A DTensor of global ``shape`` placed by ``spec`` whose local shard is
    a ``meta`` tensor (no storage).  The spec's axes must divide their dims,
    as the sharding rules guarantee."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    sizes = shr.axis_sizes(mesh)
    local = list(shape)
    for dim, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                if local[dim] % sizes[name]:
                    raise ValueError(f"dim {dim} of {shape} does not divide over {name}")
                local[dim] //= sizes[name]
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"), mesh,
                              shr.placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _with_specs(tree, specs, mesh):
    return shr.map_with_path(lambda _, t, s: fake(t.shape, t.dtype, mesh, s),
                             tree, specs)


def param_specs(cfg: ModelConfig, mesh):
    shapes = model.init_params(cfg, 0, "meta")
    return _with_specs(shapes, shr.param_specs(shapes, mesh, cfg), mesh)


def state_specs(cfg: ModelConfig, mesh, opt: AdamW) -> TrainState:
    shapes = model.init_params(cfg, 0, "meta")
    params = _with_specs(shapes, shr.param_specs(shapes, mesh, cfg), mesh)
    opt_specs = shr.opt_specs(shapes, mesh, cfg)
    mu = _with_specs(shapes, opt_specs, mesh)
    nu = _with_specs(shapes, opt_specs, mesh)
    return TrainState(params=params, opt_state=AdamState(step=0, mu=mu, nu=nu), step=0)


def batch_specs(cfg: ModelConfig, mesh, global_batch: int, seq_len: int) -> dict:
    b2 = shr.batch_spec(mesh, global_batch, 2)
    b3 = shr.batch_spec(mesh, global_batch, 3)
    batch = {
        "tokens": fake((global_batch, seq_len), torch.int32, mesh, b2),
        "labels": fake((global_batch, seq_len), torch.int32, mesh, b2),
    }
    if cfg.n_enc_layers:
        batch["enc_input"] = fake((global_batch, cfg.enc_seq, cfg.d_model),
                                  torch.float32, mesh, b3)
    if cfg.n_vis_tokens:
        batch["vis_input"] = fake((global_batch, cfg.n_vis_tokens, cfg.d_model),
                                  torch.float32, mesh, b3)
    return batch


def cache_specs(cfg: ModelConfig, mesh, batch: int, max_len: int):
    shapes = model.init_cache(cfg, batch, max_len, "meta")
    return _with_specs(shapes, shr.cache_specs(shapes, mesh), mesh)


def build_cell(cfg: ModelConfig, shape_name: str, mesh):
    """Returns (fn, args) for one dry-run cell."""
    info = SHAPES[shape_name]
    gb, sl = info["global_batch"], info["seq_len"]
    kind = info["kind"]

    if kind == "train":
        opt = AdamW(lr=1e-4, weight_decay=0.01, grad_clip=1.0)
        fn = make_train_step(cfg, opt)
        return fn, (state_specs(cfg, mesh, opt), batch_specs(cfg, mesh, gb, sl))

    if kind == "prefill":
        def fn(params, batch):
            return model.prefill(params, cfg, batch["tokens"], max_len=sl,
                                 enc_input=batch.get("enc_input"),
                                 vis_input=batch.get("vis_input"))

        batch = batch_specs(cfg, mesh, gb, sl)
        batch.pop("labels")
        return fn, (param_specs(cfg, mesh), batch)

    if kind == "decode":
        def fn(params, cache, token, pos):
            return model.decode_step(params, cache, cfg, token, pos)

        token = fake((gb, 1), torch.int32, mesh, shr.batch_spec(mesh, gb, 2))
        # The last position of the cache: the step reads every slot.
        return fn, (param_specs(cfg, mesh), cache_specs(cfg, mesh, gb, sl), token,
                    sl - 1)

    raise ValueError(kind)


# ---------------------------------------------------------------------------
# GRF-GP cell: the paper's own technique on the production mesh.
# ---------------------------------------------------------------------------

def build_gp_cell(mesh, n_nodes: int = 1 << 20, n_walkers: int = 100,
                  l_max: int = 3, cg_iters: int = 64, compress: bool = False,
                  compact: bool = False):
    """Distributed CG solve of (K̂+σ²I)v = b with row-sharded GRF features
    (Lemma 1 on 1M nodes).  Rows over (pod, data); columns dense.

    ``compact`` stores the trace payload as (int32 cols, bf16 loads, int8
    lens): 7 B a slot instead of 12.  The solve runs ``cg_iters`` fixed
    iterations (``solvers.DRYRUN_DEFAULT``, ``fixed_unrolled``), so the
    count covers every iteration and all-reduce.

    The GP path shards by process rank, not by DTensor: ``fn`` runs
    ``gp_shard.sharded_cg_solve`` on a ``ServingMesh`` over this rank's
    subgroup of the data axes (the ranks of one ``model`` column).  Its
    arguments are DTensors whose rows are split over those axes; since the
    solve takes the global trace and slices its own rows, ``fn`` hands it
    ``meta`` tensors of the global shapes (no data moves on ``meta``)."""
    from ..core.walks import WalkTrace
    from ..distributed.gp_shard import sharded_cg_solve
    from ..solvers import DRYRUN_DEFAULT
    from .mesh import ServingMesh

    k = n_walkers * (l_max + 1)
    axes = shr.data_axes(mesh)
    sub = mesh[axes[0]] if len(axes) == 1 else mesh[axes]._flatten()
    rows = ServingMesh(sub.get_group(), sub.size(), sub.get_local_rank())
    trace = WalkTrace(
        cols=fake((n_nodes, k), torch.int32, mesh, (axes, None)),
        loads=fake((n_nodes, k), torch.bfloat16 if compact else torch.float32,
                   mesh, (axes, None)),
        lens=fake((n_nodes, k), torch.int8 if compact else torch.int32, mesh,
                  (axes, None)),
    )
    f = fake((l_max + 1,), torch.float32, mesh, (None,))
    b = fake((n_nodes,), torch.float32, mesh, (axes,))

    def whole(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    def fn(trace, f, b):
        return sharded_cg_solve(
            WalkTrace(whole(trace.cols), whole(trace.loads), whole(trace.lens)),
            whole(f), whole(b), rows,
            sigma_n2=0.1, strategy=DRYRUN_DEFAULT.with_(max_iters=cg_iters),
            fixed_unrolled=True, compress=compress)

    return fn, (trace, f, b)
