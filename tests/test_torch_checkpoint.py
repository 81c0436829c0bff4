"""PyTorch port, checkpoints (``repro_torch.checkpoint``): the counterparts of
tests/test_checkpoint.py (less the LM training resume, which waits for the
port's training path), the leaf keys of JAX's ``_flatten`` for the same
tree, and ``ServeState`` checkpoints carried across the two packages in
both directions, moments within 1e-4 of scale.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop, serving  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint import manager as tmanager  # noqa: E402
from repro_torch.core import walks as twalks  # noqa: E402
from repro_torch.serving import update as tupdate  # noqa: E402

CPU = "cpu"
TOL = 1e-4


def close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def test_save_restore_roundtrip(tmp_path):
    tree = {
        "a": torch.arange(12.0).reshape(3, 4),
        "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32),
              "d": torch.tensor(2.5)},
        "e": [np.arange(4, dtype=np.int64), 7, 0.25, True],
        "f": None,
    }
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(5, tree, extra={"note": "hi"})
    restored, manifest = mgr.restore(tree)
    assert manifest["step"] == 5 and manifest["extra"]["note"] == "hi"
    assert manifest["keys"] == sorted(["a", "b/c", "b/d", "e/0", "e/1", "e/2", "e/3"])
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.int32
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    assert float(restored["b"]["d"]) == 2.5
    np.testing.assert_array_equal(restored["e"][0], tree["e"][0])
    assert restored["e"][1:] == [7, 0.25, True] and restored["f"] is None
    assert type(restored["e"][1]) is int and type(restored["e"][3]) is bool


def test_keep_n_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.tensor(float(s))})
    assert mgr.steps() == [3, 4]


def test_interrupted_save_invisible(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.tensor(1.0)})
    os.makedirs(tmp_path / "step_0000000002.tmp")
    os.makedirs(tmp_path / "step_0000000003")  # no manifest either
    assert mgr.latest_step() == 1
    mgr.save(4, {"x": torch.tensor(4.0)})      # a later save GCs the orphan
    assert not (tmp_path / "step_0000000002.tmp").exists()
    assert mgr.latest_step() == 4


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, {"x": torch.ones((256, 256))}, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 7


def test_async_save_copies_on_the_caller_thread(tmp_path):
    """Writes to a tensor or array after a non-blocking save do not reach
    the checkpoint: the host copies are taken before the writer starts."""
    x, a = torch.zeros(1000), np.zeros(1000, np.int32)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": x, "a": a}, blocking=False)
    x.fill_(5.0)
    a[:] = 3
    mgr.wait()
    tree, _ = mgr.restore({"x": x, "a": a})
    assert float(tree["x"].abs().max()) == 0.0 and int(np.abs(tree["a"]).max()) == 0


def test_elastic_restore_shape_check(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones((4, 4))})
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.ones((8, 8))})
    with pytest.raises(KeyError):
        mgr.restore({"v": torch.ones((4, 4))})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"w": torch.ones(1)})


def test_restore_casts_to_the_example_dtype(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": np.arange(6, dtype=np.int64).reshape(2, 3)})
    tree, _ = mgr.restore({"w": torch.zeros((2, 3), dtype=torch.float32)})
    assert tree["w"].dtype == torch.float32 and tree["w"].device.type == "cpu"
    assert tree["w"].tolist() == [[0, 1, 2], [3, 4, 5]]


def test_bf16_leaf_raises_naming_it(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(TypeError, match="'p/w'"):
        mgr.save(1, {"p": {"w": torch.ones(2, dtype=torch.bfloat16)}})
    mgr.save(1, {"p": {"w": torch.ones(2)}})
    with pytest.raises(TypeError, match="'p/w'"):
        mgr.restore({"p": {"w": torch.ones(2, dtype=torch.bfloat16)}})


# ---------------------------------------------------------------------------
# Against the JAX package.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro import serving as jserving
    from repro.checkpoint import CheckpointManager as JManager
    from repro.checkpoint import manager as jmanager
    from repro.core import modulation as jmod
    from repro.core import walks as jwalks
    from repro.graphs import generators as jgen
    from repro.serving import update as jupdate

    class JX:
        pass

    j = JX()
    j.jax, j.jnp, j.serving, j.update = jax, jnp, jserving, jupdate
    j.Manager, j.manager, j.walks = JManager, jmanager, jwalks
    j.g = jgen.grid2d(10, 10)
    m = jmod.diffusion(l_max=4)
    j.f = np.asarray(m(m.init(jax.random.PRNGKey(1))))
    j.key = jax.random.PRNGKey(0)
    j.cfg = jwalks.WalkConfig(n_walkers=6, p_halt=0.25, l_max=4)
    j.tg = interop.graph_from_numpy(j.g.neighbors, j.g.weights, j.g.deg, device=CPU)
    j.empty = j.serving.init_state(j.g, j.key, jnp.asarray(j.f), 0.05,
                                   capacity=24, cfg=j.cfg)
    j.tempty = serving.init_state(j.tg, int(jwalks.walk_seed(j.key)),
                                  torch.from_numpy(j.f.copy()), 0.05, 24,
                                  twalks.WalkConfig(6, 0.25, 4))
    rng = np.random.default_rng(0)
    j.nodes = rng.choice(100, 14, replace=False).astype(np.int32)
    j.ys = rng.standard_normal(14).astype(np.float32)
    return j


def test_key_strings_match_jax_flatten(jx):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 2)).astype(np.float32)
    cols = rng.integers(0, 9, (2, 3)).astype(np.int32)
    loads = rng.standard_normal((2, 3)).astype(np.float32)
    jtree = (jx.jnp.asarray(a),
             jx.walks.WalkTrace(jx.jnp.asarray(cols), jx.jnp.asarray(loads),
                                jx.jnp.asarray(cols)),
             {"b": [jx.jnp.asarray(a[0]), jx.jnp.asarray(1.5)],
              "a": jx.jnp.asarray(cols[0])})
    ttree = (torch.from_numpy(a),
             twalks.WalkTrace(torch.from_numpy(cols), torch.from_numpy(loads),
                              torch.from_numpy(cols)),
             {"b": [torch.from_numpy(a[0]), torch.tensor(1.5)],
              "a": torch.from_numpy(cols[0])})
    want = jx.manager._flatten(jtree)
    got = tmanager._flatten(ttree)
    assert list(got) == list(want)
    assert {"0", "1/0", "1/1", "1/2", "2/a", "2/b/0"} <= set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    # The packed ServeState: the same keys in both packages.
    assert list(tmanager._flatten(tupdate._pack(jx.tempty))) == list(
        jx.manager._flatten(jx.update._pack(jx.empty)))


def test_jax_serve_state_checkpoint_restores_in_port(jx, tmp_path):
    js = jx.serving.observe_batch(jx.empty, jx.nodes, jx.ys)
    jx.Manager(str(tmp_path)).save(3, jx.update._pack(js),
                                   extra={"journal_seq": 4})
    packed, manifest = CheckpointManager(str(tmp_path)).restore(
        tupdate._pack(jx.tempty))
    ts = tupdate._unpack(jx.tempty, packed)
    assert manifest["extra"] == {"journal_seq": 4}
    assert int(ts.count) == int(js.count) == 14
    assert ts.count.dtype == torch.int32 and ts.trace.cols.dtype == torch.int32
    q = np.arange(100, dtype=np.int32)
    tm, tv = serving.posterior_moments(ts, torch.from_numpy(q))
    jm, jv = jx.serving.posterior_moments(js, q)
    close(tm, jm)
    close(tv, jv)


def test_port_serve_state_checkpoint_restores_in_jax(jx, tmp_path):
    ts = serving.observe_batch(jx.tempty, jx.nodes, jx.ys)
    CheckpointManager(str(tmp_path)).save(2, tupdate._pack(ts),
                                          extra={"journal_seq": 1})
    with open(tmp_path / "step_0000000002" / "MANIFEST.json") as fh:
        assert json.load(fh)["step"] == 2
    packed, _ = jx.Manager(str(tmp_path)).restore(jx.update._pack(jx.empty))
    js = jx.update._unpack(jx.empty, packed)
    q = np.arange(100, dtype=np.int32)
    tm, tv = serving.posterior_moments(ts, torch.from_numpy(q))
    jm, jv = jx.serving.posterior_moments(js, q)
    close(tm, jm)
    close(tv, jv)


@pytest.fixture()
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_gpu_restore_lands_on_the_example_device(cuda, tmp_path):
    x = torch.arange(10, dtype=torch.float32, device=cuda)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": x}, blocking=False)
    mgr.wait()
    tree, _ = mgr.restore({"x": torch.zeros(10, device=cuda)})
    assert tree["x"].device == x.device and torch.equal(tree["x"], x)
