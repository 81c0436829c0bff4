"""PyTorch port, the LM's sharding rules (``repro_torch.launch.sharding``)
and the cost accounting's formulas (``launch/hlo_analysis.py``) against the
JAX package.

Twins of tests/test_sharding.py's rule tests with JAX's own asserts, then
leaf-for-leaf parity: every parameter, ZeRO-1 moment and decode-cache leaf
of the ten configs at full width gets the same spec from both packages on
the 16×16, 2×16×16 and 4×2 meshes, with ``fsdp`` on and off.  Both rule
sets are given one JAX ``AbstractMesh`` (the port's rules read any mesh
with axis names and sizes); the port's trees come from ``init_params`` and
``init_cache`` on ``meta``, JAX's from ``jax.eval_shape``.  Exact
equality throughout: the rules are integer arithmetic.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.models import model  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def test_param_spec_divisibility_fallback():
    mesh = _FakeMesh({"data": 16, "model": 16})
    # 8 heads never divide model=16 → falls back to head_dim or replication
    spec = S.param_spec("wq", (2560, 8, 320), mesh, fsdp=False, stacked=False)
    assert spec[1] is None and spec[2] == "model"  # 320 % 16 == 0
    spec = S.param_spec("wq", (2560, 8, 10), mesh, fsdp=False, stacked=False)
    assert spec[1] is None and spec[2] is None
    # stacked leaves get a leading None
    spec = S.param_spec("gate", (24, 2560, 10240), mesh, fsdp=True, stacked=True)
    assert spec == (None, "data", "model")


def test_batch_spec():
    mesh = _FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert S.batch_spec(mesh, 256, 2) == (("pod", "data"), None)
    assert S.batch_spec(mesh, 1, 2) == (None, None)   # indivisible → replicate


def test_placements_of_a_device_mesh():
    """A DeviceMesh's dims are named by ``mesh_dim_names``; a tensor dim
    split over (pod, data) is sharded by both, pod first."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 shape=(2, 16, 16))
    assert S.axis_sizes(mesh) == {"pod": 2, "data": 16, "model": 16}
    assert S.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert S.placements((None, None), mesh) == (Replicate(),) * 3


def test_constrain_is_a_noop_without_a_mesh():
    x = torch.randn(4, 8)
    S.set_activation_mesh(None)
    assert S.get_activation_mesh() is None
    assert S.constrain(x, "batch", "model") is x


@pytest.fixture(scope="module")
def jax_trees():
    """Per arch: JAX's eval_shape parameter tree, its config, and its
    decode-cache trees (decode_32k, and long_500k where subquadratic)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jget
    from repro.models import model as jmodel
    from repro.models.config import SHAPES

    out = {}
    for arch in list_archs():
        cfg = jget(arch)
        params = jax.eval_shape(lambda k, c=cfg: jmodel.init_params(c, k),
                                jax.random.PRNGKey(0))
        caches = {}
        for shape in ("decode_32k", "long_500k"):
            if shape == "long_500k" and not cfg.subquadratic:
                continue
            info = SHAPES[shape]
            caches[shape] = jax.eval_shape(
                lambda c=cfg, i=info: jmodel.init_cache(c, i["global_batch"], i["seq_len"]))
        out[arch] = (cfg, params, caches)
    return out


def _abstract(name):
    from jax.sharding import AbstractMesh

    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def _jax_by_path(tree, fn):
    """{path: tuple(spec)} of a JAX tree, paths as the port prints them."""
    import jax
    from repro.launch import sharding as jshr

    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(jshr._key_str(k) for k in path): fn(path, leaf) for path, leaf in flat}


def _port_by_path(tree):
    out = {}
    S.map_with_path(lambda path, s: out.__setitem__(path, s), tree)
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_param_and_opt_specs_equal_jax(jax_trees, arch):
    """``param_spec`` (through ``_leaf_specs``) and the ZeRO-1 ``opt_specs``
    of every leaf, on the three meshes, fsdp on and off."""
    from repro.launch import sharding as jshr

    jcfg, jparams, _ = jax_trees[arch]
    params = model.init_params(get_config(arch), 0, "meta")
    for mesh_name in MESHES:
        mesh = _abstract(mesh_name)
        for fsdp in (True, False):
            jc = dataclasses.replace(jcfg, fsdp=fsdp)
            pc = dataclasses.replace(get_config(arch), fsdp=fsdp)
            want = _jax_by_path(jshr._leaf_specs(jparams, mesh, fsdp),
                                lambda _, s: tuple(s))
            got = _port_by_path(S.param_specs(params, mesh, pc))
            assert got == want, (mesh_name, fsdp)
            want = _jax_by_path(jshr.opt_shardings(jparams, mesh, jc),
                                lambda _, s: tuple(s.spec))
            got = _port_by_path(S.opt_specs(params, mesh, pc))
            assert got == want, (mesh_name, fsdp)


@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_equal_jax(jax_trees, arch):
    from repro.launch import sharding as jshr
    from repro_torch.models.config import SHAPES

    _, _, jcaches = jax_trees[arch]
    for shape, jcache in jcaches.items():
        info = SHAPES[shape]
        cache = model.init_cache(get_config(arch), info["global_batch"],
                                 info["seq_len"], "meta")
        for mesh_name in MESHES:
            mesh = _abstract(mesh_name)
            want = _jax_by_path(jcache, lambda path, leaf: tuple(jshr.cache_entry_spec(
                jshr._key_str(path[-1]), leaf.shape, mesh)))
            got = _port_by_path(S.cache_specs(cache, mesh))
            assert got == want, (shape, mesh_name)


def test_wire_factors_and_roofline_match_jax(monkeypatch):
    """The ring-model factors for A in 1..16, and ``roofline_terms`` equal
    to JAX's formula once JAX's constants are set to the H100's."""
    from repro.launch import hlo_analysis as jh

    for op, fn in jh._WIRE_FACTOR.items():
        for a in range(1, 17):
            assert H._WIRE_FACTOR[op](a) == fn(a)
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jh, name, getattr(H, name))
    for cost, wire in (({"flops": 5.9e13, "bytes accessed": 4.5e12}, 3.6e11),
                       ({"flops": 1e9, "bytes accessed": 1e12}, 0.0),
                       ({"flops": 1e6, "bytes accessed": 1e3}, 1e9)):
        colls = {"total_wire_bytes": wire}
        assert H.roofline_terms(cost, colls) == jh.roofline_terms(cost, colls)


def test_collective_stats_match_jax_hlo_parse():
    """The same collectives as JAX reads them from HLO text (per-device
    shapes, replica groups) and as the port records them (type, bytes,
    group size): equal totals per type."""
    from repro.launch import hlo_analysis as jh

    hlo = "\n".join([
        "%ar = f32[1024,16]{1,0} all-reduce(f32[1024,16]{1,0} %p), replica_groups=[2,4]<=[8]",
        "%ag = bf16[64,2560]{1,0} all-gather(bf16[4,2560]{1,0} %q), replica_groups=[1,16]<=[16]",
        "%rs = f32[8,128]{1,0} reduce-scatter(f32[64,128]{1,0} %r), replica_groups={{0,1,2,3,4,5,6,7}}",
        "%aa = f32[32,32]{1,0} all-to-all(f32[32,32]{1,0} %s), replica_groups=[4,2]<=[8]",
        "%t = (f32[10]{0}, s32[6]{0}) all-reduce(f32[10]{0} %a, s32[6]{0} %b), replica_groups=[2,4]<=[8]",
        "%one = f32[99]{0} all-reduce(f32[99]{0} %c), replica_groups=[8,1]<=[8]",
    ])
    records = [("all-reduce", 1024 * 16 * 4, 4), ("all-gather", 64 * 2560 * 2, 16),
               ("reduce-scatter", 8 * 128 * 4, 8), ("all-to-all", 32 * 32 * 4, 2),
               ("all-reduce", 10 * 4 + 6 * 4, 4), ("all-reduce", 99 * 4, 1)]
    want = jh.collective_stats(hlo)
    got = H.collective_stats(records)
    assert got["n_collectives"] == want["n_collectives"] == 5
    for key in ("bytes_by_type", "wire_bytes_by_type"):
        assert got[key] == pytest.approx(want[key], rel=1e-12)
    assert got["total_wire_bytes"] == pytest.approx(want["total_wire_bytes"], rel=1e-12)
