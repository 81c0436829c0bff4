"""PyTorch port, the LM's train step with DTensor state on a 2×2 mesh of 4
gloo ranks — ``fsdp``, ZeRO-1 and ``sp_attn`` on — against the same step
in one process on plain tensors.

Reduced danube (float32, seq 32, batch 4) in two cases: head-parallel
(4 query and 4 kv heads: attention split by heads over ``model``) and
sequence-parallel (3 query heads, 1 kv head: the query sequence split over
``model`` and K/V replicated, which runs the attention kernel's wrapper
with each shard's global ``q_offset``).  One module-scoped spawn of 4 ranks
(``launch.mesh.spawn_ranks``) runs both; rank 0 saves the gathered
results.

Tolerances, relative to each leaf's scale: the loss, the gradient norm,
every gradient and μ, ν after the step 1e-5 against the single-process
step (the same arithmetic in other summation orders: partial sums reduced
over ranks).  The params after the step 1e-5 too, except where Adam's
first step g/(|g| + ε) amplifies the gradient difference: an element whose
difference d (measured, plus 1e-7 of the leaf's gradient scale for the
step's own reduction order) can move its step, lr·d·ε/(max(|g| − d, 0) +
ε)², by more than a tenth of the tolerance is held to 2·lr instead
(``chip_smoke.adam_step_check``'s rule).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as tmesh  # noqa: E402

CASES = ("head", "seq")


def _cfg(case):
    from repro_torch.configs import get_config, reduce_config

    cfg = dataclasses.replace(reduce_config(get_config("h2o-danube-1.8b")),
                              fsdp=True, zero1=True, sp_attn=True)
    if case == "seq":
        cfg = dataclasses.replace(cfg, n_heads=3, n_kv_heads=1)
    return cfg


def _batch(cfg):
    t = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 33))
    return {"tokens": torch.from_numpy(t[:, :-1].astype(np.int32)),
            "labels": torch.from_numpy(t[:, 1:].astype(np.int32))}


def _opt():
    from repro_torch.optim.adamw import AdamW

    return AdamW(lr=1e-3, weight_decay=0.01, grad_clip=1.0)


def _worker(rank, out_dir):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import sharding as shr
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.optim.adamw import AdamState

    from repro_torch.kernels.flash_attention import ops as flash_ops

    mesh = tmesh.make_host_mesh(2, 2, device_type="cpu")
    seen = {case: set() for case in CASES}
    plain = flash_ops.mha_ref

    def recording(*args, q_offset=0, **kw):   # the shard's plain attention
        seen[case].add(q_offset)
        return plain(*args, q_offset=q_offset, **kw)

    flash_ops.mha_ref = recording
    res = {}
    for case in CASES:
        cfg, opt = _cfg(case), _opt()
        params = model.init_params(cfg, 0, "cpu")
        zeros = opt.init(params)
        p = shr.distribute(params, mesh, shr.param_shardings(params, mesh, cfg))
        o = shr.opt_shardings(params, mesh, cfg)
        mu, nu = shr.distribute(zeros.mu, mesh, o), shr.distribute(zeros.nu, mesh, o)
        bp = shr.placements(shr.batch_spec(mesh, 4, 2), mesh)
        batch = {k: distribute_tensor(v, mesh, bp) for k, v in _batch(cfg).items()}
        shr.set_activation_mesh(mesh)
        try:
            with shr.spmd(p):
                _, _, grads = train.loss_and_grads(p, cfg, batch)
            state, m = train.make_train_step(cfg, opt)(
                train.TrainState(p, AdamState(0, mu, nu), 0), batch)
        finally:
            shr.set_activation_mesh(None)
        res[case] = {"grads": shr.to_full(grads), "params": shr.to_full(state.params),
                     "mu": shr.to_full(state.opt_state.mu),
                     "nu": shr.to_full(state.opt_state.nu),
                     "loss": m["loss"].full_tensor(), "grad_norm": m["grad_norm"].full_tensor()}
    flash_ops.mha_ref = plain
    torch.save(seen, f"{out_dir}/offsets{rank}.pt")
    if rank == 0:
        torch.save(res, f"{out_dir}/sharded.pt")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_train")
    tmesh.spawn_ranks(_worker, 4, init_method=f"file://{d}/store", timeout_s=240,
                      args=(str(d),))
    offsets = [torch.load(d / f"offsets{r}.pt") for r in range(4)]
    return torch.load(d / "sharded.pt"), offsets


def _single(case):
    from repro_torch.launch import train
    from repro_torch.models import model

    cfg, opt = _cfg(case), _opt()
    params = model.init_params(cfg, 0, "cpu")
    _, _, grads = train.loss_and_grads(params, cfg, _batch(cfg))
    state, m = train.make_train_step(cfg, opt)(
        train.TrainState(params, opt.init(params), 0), _batch(cfg))
    return grads, state, m


def _leaves(tree):
    from repro_torch.launch import sharding as shr

    out = {}
    shr.map_with_path(lambda path, t: out.__setitem__(path, t.detach().double()), tree)
    return out


def _close(got, want, tol):
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) / scale <= tol


@pytest.mark.parametrize("case", CASES)
def test_sharded_train_step_matches_one_process(sharded, case):
    got = sharded[0][case]
    grads, state, m = _single(case)
    for k in ("loss", "grad_norm"):
        assert _close(got[k].double(), m[k].double(), 1e-5), k
    for name, want in (("grads", grads), ("mu", state.opt_state.mu),
                       ("nu", state.opt_state.nu)):
        g, w = _leaves(got[name]), _leaves(want)
        assert g.keys() == w.keys()
        for path in w:
            assert _close(g[path], w[path], 1e-5), (name, path)
    opt = _opt()
    clip = min(1.0, opt.grad_clip / float(m["grad_norm"]))
    p_got, p_want = _leaves(got["params"]), _leaves(state.params)
    g_got, g_want = _leaves(got["grads"]), _leaves(grads)
    for path in p_want:
        scale = max(float(p_want[path].abs().max()), 1e-30)
        g = g_want[path].abs() * clip
        d = ((g_got[path] - g_want[path]).abs() + 1e-7 * g_want[path].abs().max()) * clip
        slope = opt.lr * d * opt.eps / ((g - d).clamp(min=0) + opt.eps) ** 2
        held = slope <= 1e-5 * scale / 10
        err = (p_got[path] - p_want[path]).abs()
        assert float((err * held).max()) <= 1e-5 * scale, ("params", path)
        assert float(err.max()) <= 2 * opt.lr + 1e-5 * scale, ("params", path)
        assert held.double().mean() > 0.99, ("params", path)


def test_sequence_parallel_attention_runs_at_each_shards_offset(sharded):
    """3 query heads do not divide the model axis of 2, so the seq case
    splits the query sequence: the ranks of model coordinate 1 attend from
    position 16 of 32.  The head case keeps whole sequences (offset 0)."""
    offsets = sharded[1]
    for r, seen in enumerate(offsets):
        assert seen["head"] == {0}
        assert seen["seq"] == {16 * (r % 2)}
