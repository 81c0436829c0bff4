"""PyTorch port, the dry run (``repro_torch.launch.dryrun``, ``specs``,
``hlo_analysis``) on a fake 4×2 process group in this process — the twin
of tests/test_sharding.py::test_cells_lower_on_small_mesh.

The group is ``torch.testing``'s fake backend (8 ranks, collectives move
nothing) and every input a DTensor whose shard lives on ``meta``; the
module's fixture starts it and destroys it afterwards.  JAX's reference
cells are compiled in a subprocess on a 4×2 mesh of ``Auto`` axes (the
installed jax's ``make_mesh`` defaults to ``Explicit`` ones, on which the
embedding gather does not lower: ROADMAP Queue 3), with ``keep_unused``
so that XLA keeps every argument.

What is held, per device:
  * every reduced cell (danube, mamba2, whisper × train / decode at seq 64,
    batch 8) traces, with FLOPs > 0;
  * argument bytes equal XLA's ``memory_analysis`` less the int32 scalars
    JAX passes as arrays and the port keeps on the host (train: the two
    step counters, 8 B; decode: ``pos``, 4 B);
  * a matmul sharded on both mesh dims counts global/8 (JAX's own check);
  * reduced danube's train step counts exactly the analytic GEMM and
    attention FLOPs;
  * that count is within 10 % under JAX's trip-count-corrected
    ``_corrected_summary`` (measured 7.5 %: XLA counts elementwise FLOPs
    too, the port only matmuls and attention);
  * the GRF-GP cell at small N: its argument bytes and its collectives
    (one operator all-reduce and two dot all-reduces per CG iteration).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis, specs  # noqa: E402
from repro_torch.models import config as mconfig  # noqa: E402

CELLS = [(a, s) for a in ("h2o-danube-1.8b", "mamba2-2.7b", "whisper-base")
         for s in ("train_4k", "decode_32k")]
HOST_SCALARS = {"train_4k": 8, "decode_32k": 4}

JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
from jax.sharding import AxisType
from repro.configs import get_config, reduce_config
from repro.launch import dryrun, specs
from repro.launch.hlo_analysis import summarize_compiled
from repro.models.config import SHAPES

mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
for shape in ["train_4k", "decode_32k"]:
    SHAPES[shape] = dict(SHAPES[shape], seq_len=64, global_batch=8)
out = {}
for arch in ["h2o-danube-1.8b", "mamba2-2.7b", "whisper-base"]:
    cfg = reduce_config(get_config(arch))
    for shape in ["train_4k", "decode_32k"]:
        fn, args = specs.build_cell(cfg, shape, mesh)
        with mesh:
            compiled = jax.jit(fn, keep_unused=True).lower(*args).compile()
        out[arch + "/" + shape] = summarize_compiled(compiled)["memory"]["argument_bytes"]
c = dryrun._corrected_summary(reduce_config(get_config("h2o-danube-1.8b")), "train_4k", mesh)
out["corrected_flops"] = c["cost"]["flops"]
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_host_mesh

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield make_host_mesh(4, 2, device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_ref():
    pytest.importorskip("jax")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT], capture_output=True,
                         text=True, timeout=600, env=env, cwd=root)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("JSON")]
    assert line, res.stdout[-2000:] + res.stderr[-3000:]
    return json.loads(line[0][4:])


@pytest.fixture(scope="module")
def records(mesh, tmp_path_factory):
    """The six reduced cells, traced once (shapes patched for the call)."""
    out_dir = str(tmp_path_factory.mktemp("dryrun"))
    saved = {s: mconfig.SHAPES[s] for s in ("train_4k", "decode_32k")}
    try:
        for s in saved:
            mconfig.SHAPES[s] = dict(saved[s], seq_len=64, global_batch=8)
        return {(a, s): dryrun.run_cell(a, s, mesh, "host_4x2", out_dir,
                                        cfg_override=reduce_config(get_config(a)))
                for a, s in CELLS}
    finally:
        mconfig.SHAPES.update(saved)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cells_trace_on_small_mesh(records, arch, shape):
    rec = records[(arch, shape)]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["roofline"]["flops_per_device"] > 0
    assert rec["probes"] == [] and "no trip-count probes" in rec["counting"]
    assert rec["attention"] == "mha_ref"
    assert rec["memory"]["argument_bytes"] > 0


@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_equal_jax(records, jax_ref, arch, shape):
    got = records[(arch, shape)]["memory"]["argument_bytes"]
    assert got + HOST_SCALARS[shape] == jax_ref[f"{arch}/{shape}"]


def test_sharded_matmul_counts_global_over_8(mesh):
    a = specs.fake((64, 32), torch.float32, mesh, ("data", "model"))
    b = specs.fake((32, 16), torch.float32, mesh, ("model", None))
    rec = hlo_analysis.summarize(lambda x, y: x @ y, (a, b))
    assert rec["cost"]["flops"] == 2 * 64 * 32 * 16 / 8
    # a's shard is 1/8 of it, b's (split over model only) 1/2.
    assert rec["memory"]["argument_bytes"] == (64 * 32 // 8 + 32 * 16 // 2) * 4


def _danube_analytic() -> int:
    """Per-device FLOPs of reduced danube's train step on (data 4, model 2):
    2 rows × 64 tokens a device, heads and MLP columns halved over model,
    the tied 503-row unembedding replicated (503 is odd); backward twice
    the forward, no remat (``reduce_config`` turns it off)."""
    cfg = reduce_config(get_config("h2o-danube-1.8b"))
    t, s, b = 128, 64, 2
    d, hhd, f, v = cfg.d_model, cfg.n_heads * cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size
    heads_local = cfg.n_heads // 2
    attn = 2 * (2 * s * s * cfg.resolved_head_dim) * b * heads_local
    layer = (3 * 2 * t * d * hhd // 2) + attn + (2 * t * hhd * d // 2) + 3 * 2 * t * d * f // 2
    n_layers = cfg.n_layers
    return 3 * (n_layers * layer + 2 * t * d * v)


def test_reduced_danube_train_flops_are_the_analytic_count(records):
    assert records[("h2o-danube-1.8b", "train_4k")]["cost"]["flops"] == _danube_analytic()


def test_flops_within_tolerance_of_jax_corrected(records, jax_ref):
    got = records[("h2o-danube-1.8b", "train_4k")]["cost"]["flops"]
    ratio = got / jax_ref["corrected_flops"]
    assert 0.9 <= ratio <= 1.0, ratio


@pytest.mark.parametrize("compact", [False, True])
def test_gp_cell_small(mesh, tmp_path, compact):
    n, walkers, l_max, iters = 1024, 4, 3, 4
    k = walkers * (l_max + 1)
    rec = dryrun.run_gp_cell(mesh, "host_4x2", str(tmp_path), compact=compact)
    assert rec["status"] == "ok", rec.get("traceback")   # the full-size cell
    fn, args = specs.build_gp_cell(mesh, n_nodes=n, n_walkers=walkers, l_max=l_max,
                                   cg_iters=iters, compact=compact)
    rec = hlo_analysis.summarize(fn, args)
    slot = 4 + (2 + 1 if compact else 4 + 4)
    rows = n // 4                       # rows over the data axis
    assert rec["memory"]["argument_bytes"] == rows * k * slot + (l_max + 1) * 4 + rows * 4
    colls = rec["collectives"]
    # All-reduces over the 4 data ranks: the operator's partial Φᵀv and the
    # two inner products of each iteration, plus the setup's; the result's
    # row blocks gathered once.
    assert colls["bytes_by_type"]["all-gather"] == n * 4
    assert colls["n_collectives"] == 3 * iters + 4
    assert rec["cost"]["flops"] > 0


def test_compact_payload_matches_the_plain_one():
    """A compact trace (bf16 loads, int8 lens) gives the products of the
    plain trace whose loads are the same bf16 values: bit for bit."""
    from repro_torch.core import features, walks
    from repro_torch.graphs import generators

    tr = walks.sample_walks(generators.ring(64, k=2, device="cpu"), 7, n_walkers=4,
                            p_halt=0.2, l_max=3)
    compact = walks.WalkTrace(tr.cols, tr.loads.to(torch.bfloat16), tr.lens.to(torch.int8))
    plain = walks.WalkTrace(tr.cols, compact.loads.float(), tr.lens)
    f = torch.tensor([1.0, 0.5, 0.25, 0.125])
    u = torch.randn(64, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(features.phi_matvec(compact, f, u), features.phi_matvec(plain, f, u))

