"""PyTorch port, LM training: remat, the in-place AdamW, the train step
(with microbatches) and the train loop against the JAX package, kill and
resume, a JAX checkpoint resumed by the port, and the example driver.

Reduced configs (d_model 64, vocab 503, two repeats), float32.  One train
state is made by the JAX package's ``init_state(PRNGKey(0))`` and carried
across with ``interop.train_state_from_numpy``, so both packages start from
the same params, μ and ν.  Tolerances, relative to each leaf's scale:
1e-5 for one train step's μ, ν, loss and grad norm, and for its params
wherever the gradient is above 100·ε (ε = 1e-8, Adam's); Adam's first step
is g/(|g| + ε), whose slope at |g| ≈ ε turns the two packages' float32
gradient difference (≈1e-10 there, 1e-7 of the gradient's scale) into a
step difference of a few percent of lr, so those few elements are held to
1e-4 of scale.  1e-3 after 5 steps (the repo's Adam rule), 1e-4 for remat's gradients
against JAX and for a JAX checkpoint continued by the port; remat variants
and the functional update against the in-place one bit for bit on the CPU,
three AdamW steps against JAX's 1e-6; kill and resume 1e-6 (the JAX test's
bound).
"""
import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402

DANUBE = "h2o-danube-1.8b"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, tol):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def reduced(arch=DANUBE, **overrides):
    return dataclasses.replace(tconfigs.reduce_config(tconfigs.get_config(arch)),
                               **overrides)


def stream(cfg, batch=4, seq=16, seed=0):
    return TokenStream(vocab_size=cfg.vocab_size, global_batch=batch, seq_len=seq,
                       seed=seed, enc_seq=cfg.enc_seq, n_vis_tokens=cfg.n_vis_tokens,
                       d_model=cfg.d_model)


def equal_trees(a, b) -> bool:
    """Every leaf equal, paired by path (a restored tree's dicts are in
    sorted key order): tensors bit for bit, step counts as ints."""
    pa, pb = dict(_paths(a)), dict(_paths(b))
    assert sorted(pa) == sorted(pb)
    return all(torch.equal(x, pb[k]) if isinstance(x, torch.Tensor) else x == pb[k]
               for k, x in pa.items())


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax

    from repro import configs as jconfigs
    from repro.launch import train as jtrain
    from repro.optim import adamw as jadamw

    def jcfg(arch=DANUBE, **overrides):
        return dataclasses.replace(jconfigs.reduce_config(jconfigs.get_config(arch)),
                                   **overrides)

    return jax, jtrain, jadamw, jcfg


def test_update_in_place_is_bit_equal(jx):
    """AdamW.update_ writes into the tensors it is given, and the functional
    AdamW.update gives its params, μ and ν bit for bit while leaving its
    inputs as they were.  Both follow JAX's AdamW (clipping, weight decay, a
    cosine schedule) over three steps on the LM tree within 1e-6 of each
    leaf's scale."""
    jax, _, jadamw, _ = jx
    cfg = reduced()
    params = tmodel.init_params(cfg, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(2)
    grads = [tmodel.tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
             for _ in range(3)]
    opt = AdamW(lr=cosine_schedule(1e-2, 1, 10), weight_decay=0.01, grad_clip=0.5)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-2, 1, 10), weight_decay=0.01,
                        grad_clip=0.5)
    fp, fs = params, opt.init(params)
    ip, is_ = tmodel.tree_map(torch.clone, params), opt.init(params)
    jp = jax.tree.map(lambda t: t.numpy(), params)
    js = jopt.init(jp)
    for g in grads:
        given = (g, fs.mu, fs.nu, fp)
        kept = tmodel.tree_map(torch.clone, given)
        fp, fs = opt.update(g, fs, fp)
        assert equal_trees(given, kept)
        out, is_ = opt.update_(tmodel.tree_map(torch.clone, g), is_, ip)
        assert out is ip
        jp, js = jopt.update(jax.tree.map(lambda t: t.numpy(), g), js, jp)
    assert fs.step == is_.step == 3
    assert equal_trees(fp, ip) and equal_trees(fs.mu, is_.mu) and equal_trees(fs.nu, is_.nu)
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    for path, leaf in _paths(ip):
        close(leaf, flat[path], 1e-6)


def test_weight_decay_follows_the_rank_of_the_leaf(jx):
    """One Adam step with zero gradients on the LM tree (norms set to 0.5):
    only weight decay moves a leaf, so the stacked [repeat, d] norms move and
    final_norm does not, as in JAX (whose update is applied to the same
    tree, 1e-6)."""
    jax, _, jadamw, _ = jx
    cfg = reduced()
    params = tmodel.init_params(cfg, seed=3, device="cpu")
    params = tmodel.tree_map(lambda p: p if p.dim() > 2 else torch.full_like(p, 0.5),
                             params)
    zeros = tmodel.tree_map(torch.zeros_like, params)
    opt = AdamW(lr=0.1, weight_decay=0.01, grad_clip=1.0)
    new, _ = opt.update(zeros, opt.init(params), params)
    assert torch.equal(new["final_norm"], params["final_norm"])
    norm = params["stages"][0]["L0"]["attn"]["norm"]
    assert norm.dim() == 2
    assert torch.allclose(new["stages"][0]["L0"]["attn"]["norm"], norm * (1 - 0.1 * 0.01))
    jopt = jadamw.AdamW(lr=0.1, weight_decay=0.01, grad_clip=1.0)
    jp = jax.tree.map(lambda t: t.numpy(), params)
    jnew, _ = jopt.update(jax.tree.map(np.zeros_like, jp), jopt.init(jp), jp)
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jnew)[0]}
    for path, leaf in _paths(new):
        np.testing.assert_allclose(_np(leaf), flat[path], rtol=1e-6, atol=1e-6)


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{pre}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{pre}[{i}]")
    else:
        yield pre, tree


@pytest.mark.parametrize("arch", [DANUBE, "zamba2-7b", "whisper-base"])
def test_remat_variants_bit_equal_and_match_jax(jx, arch):
    """remat none, dots and full give bit-equal loss and gradients on the
    CPU, and each matches JAX's value_and_grad under the same remat (1e-4)."""
    jax, _, _, jcfg_of = jx
    from repro.models import model as jmodel

    base = jcfg_of(arch)
    jp = jmodel.init_params(base, jax.random.PRNGKey(0))
    tp = interop.model_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    host = stream(base, batch=2).next_batch()
    batch = ttrain.batch_to(host, "cpu")
    got = {}
    for remat in ("none", "dots", "full"):
        loss, _, grads = ttrain.loss_and_grads(tp, reduced(arch, remat=remat), batch)
        got[remat] = (loss, grads)
    for remat in ("dots", "full"):
        assert torch.equal(got[remat][0], got["none"][0])
        assert equal_trees(got[remat][1], got["none"][1])
    (jl, _), jg = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jp, dataclasses.replace(base, remat="dots"), host)
    close(got["dots"][0], jl, 1e-4)
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    for path, g in _paths(got["dots"][1]):
        close(g, flat[path], 1e-4)


@pytest.fixture(scope="module")
def carried(jx):
    """(JAX cfg, port cfg, optimisers, JAX init_state, its port copy,
    batches): danube reduced, AdamW(1e-3, wd 0.01, clip 1.0)."""
    jax, jtrain, jadamw, jcfg_of = jx
    jcfg, tcfg = jcfg_of(), reduced()
    jopt = jadamw.AdamW(lr=1e-3, weight_decay=0.01, grad_clip=1.0)
    topt = AdamW(lr=1e-3, weight_decay=0.01, grad_clip=1.0)
    jstate = jtrain.init_state(jcfg, jax.random.PRNGKey(0), jopt)
    src = stream(tcfg)
    batches = [src.next_batch() for _ in range(5)]
    return jcfg, tcfg, jopt, topt, jstate, batches


def _tstate(jax, jstate):
    return interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")


ADAM_EPS = 1e-8


def _close_step(got, want_tree, mu_tree, jax, tol):
    """Params after one Adam step within ``tol`` of each leaf's scale where
    the (clipped) gradient μ/(1 − b1) exceeds 100·ε, within 1e-4 elsewhere."""
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(want_tree)[0]}
    mus = {jax.tree_util.keystr(k): np.asarray(v)
           for k, v in jax.tree_util.tree_flatten_with_path(mu_tree)[0]}
    for path, leaf in _paths(got):
        want = flat[path].astype(np.float64)
        err = np.abs(_np(leaf).astype(np.float64) - want) / max(np.abs(want).max(), 1e-30)
        sure = np.abs(mus[path]) / (1 - 0.9) > 100 * ADAM_EPS
        assert err[sure].max(initial=0.0) <= tol, path
        assert err.max() <= 1e-4, path


def _close_params(got, want_tree, jax, tol):
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(want_tree)[0]}
    for path, leaf in _paths(got):
        close(leaf, flat[path], tol)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(jx, carried, microbatches):
    """One train step from the carried init_state: μ and ν within 1e-5 of
    each leaf's scale, params too (_close_step), the loss and grad norm
    1e-5, the metrics (with microbatches JAX's quirk: ce = the mean total,
    zloss = moe_aux = 0); the step writes into the state it is given."""
    jax, jtrain, _, _ = jx
    jcfg, tcfg, jopt, topt, jstate, batches = carried
    jstep = jax.jit(jtrain.make_train_step(jcfg, jopt, microbatches))
    jnew, jm = jstep(jstate, batches[0])
    start = _tstate(jax, jstate)
    tnew, tm = ttrain.make_train_step(tcfg, topt, microbatches)(
        start, ttrain.batch_to(batches[0], "cpu"))
    assert tnew.params["embed"] is start.params["embed"]   # updated in place
    assert tnew.step == tnew.opt_state.step == 1
    _close_step(tnew.params, jnew.params, jnew.opt_state.mu, jax, 1e-5)
    _close_params(tnew.opt_state.mu, jnew.opt_state.mu, jax, 1e-5)
    _close_params(tnew.opt_state.nu, jnew.opt_state.nu, jax, 1e-5)
    for k in ("loss", "grad_norm", "ce", "zloss", "moe_aux"):
        close(tm[k], jm[k], 1e-5)
    if microbatches > 1:
        assert float(tm["zloss"]) == float(tm["moe_aux"]) == 0.0
        assert float(tm["ce"]) == float(tm["loss"])


def test_five_train_steps_match_jax(jx, carried):
    """Five steps on five stream batches: params within 1e-3 of scale and
    the losses within 1e-4."""
    jax, jtrain, _, _ = jx
    jcfg, tcfg, jopt, topt, jstate, batches = carried
    jstep = jax.jit(jtrain.make_train_step(jcfg, jopt))
    tstep = ttrain.make_train_step(tcfg, topt)
    tstate = _tstate(jax, jstate)
    for b in batches:
        jstate, jm = jstep(jstate, b)
        tstate, tm = tstep(tstate, ttrain.batch_to(b, "cpu"))
        close(tm["loss"], jm["loss"], 1e-4)
    assert tstate.step == 5
    _close_params(tstate.params, jstate.params, jax, 1e-3)


def test_kill_and_resume_training(tmp_path):
    """Twin of test_kill_and_resume_training_is_bit_exact: 10 straight
    steps == 6 steps, a fresh train_loop call that resumes from the step-6
    checkpoint and the stream's cursor, and 4 more (1e-6)."""
    cfg = reduced()
    kw = dict(global_batch=2, seq_len=16, seed=3, device="cpu")
    straight, _ = ttrain.train_loop(cfg, steps=10, ckpt_dir=None, **kw)
    d = str(tmp_path / "run")
    mid, _ = ttrain.train_loop(cfg, steps=6, ckpt_dir=d, ckpt_every=3, **kw)
    assert mid.step == 6
    resumed, hist = ttrain.train_loop(cfg, steps=10, ckpt_dir=d, ckpt_every=3, **kw)
    assert resumed.step == 10 and [h["step"] for h in hist] == [9]
    assert equal_trees(resumed.params, straight.params)   # the CPU is deterministic
    want = dict(_paths(straight.params))
    got = dict(_paths(resumed.params))
    assert sorted(got) == sorted(want)
    for k, a in got.items():
        np.testing.assert_allclose(_np(a), _np(want[k]), rtol=1e-6, atol=1e-6)


def test_port_resumes_a_jax_checkpoint(jx, tmp_path):
    """JAX's train_loop runs 3 steps and checkpoints; the port's train_loop
    resumes that checkpoint (params, μ, ν, steps, the stream's cursor) and
    runs to step 5, as JAX's own resume does: params within 1e-4."""
    jax, jtrain, _, jcfg_of = jx
    kw = dict(global_batch=2, seq_len=16, seed=3)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jtrain.train_loop(jcfg_of(), steps=3, ckpt_dir=str(jdir), ckpt_every=3, **kw)
    shutil.copytree(jdir, tdir)
    jstate, _ = jtrain.train_loop(jcfg_of(), steps=5, ckpt_dir=str(jdir), ckpt_every=3, **kw)
    tstate, hist = ttrain.train_loop(reduced(), steps=5, ckpt_dir=str(tdir), ckpt_every=3,
                                     device="cpu", **kw)
    assert tstate.step == 5 and tstate.opt_state.step == 5 and [h["step"] for h in hist] == [4]
    _close_params(tstate.params, jstate.params, jax, 1e-4)


def test_training_reduces_loss():
    """Twin of test_training_reduces_loss: 30 AdamW(3e-3, clip 1) steps on
    one batch of 4 x 32 lower the loss by more than 0.5."""
    cfg = reduced()
    opt = AdamW(lr=3e-3, grad_clip=1.0)
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    state = ttrain.TrainState(params, opt.init(params), 0)
    batch = ttrain.batch_to(stream(cfg, batch=4, seq=32).next_batch(), "cpu")
    step = ttrain.make_train_step(cfg, opt)
    losses = []
    for _ in range(30):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_train_lm_example_runs(capsys):
    """The example driver's tiny preset on the CPU: it trains and prints
    the final step."""
    from repro_torch.examples import train_lm

    hist = train_lm.main(["--preset", "tiny", "--steps", "3", "--batch", "2",
                          "--seq", "16", "--device", "cpu"])
    assert [h["step"] for h in hist] == [0, 2]
    assert "done; final step 3" in capsys.readouterr().out


@pytest.fixture
def fake_card(monkeypatch):
    """The two LM kernels' CUDA branch on CPU tensors, with launches that
    PyTorch's dispatcher cannot see (as a ctypes launch): the output is
    allocated by torch.empty and filled through numpy.  Counts launches."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm import ref as rref

    calls = {"flash": 0, "rmsnorm": 0}

    def fill(out, value):
        out.detach().numpy()[...] = value.detach().numpy()
        return out

    def flash(inst, q, k, v, *, causal, window, softcap, q_offset=0):
        calls["flash"] += 1
        out = torch.empty(q.shape, dtype=q.dtype)
        return fill(out, fref.mha_ref(q, k, v, causal=causal, window=window,
                                      softcap=softcap, q_offset=q_offset))

    def norm(x, scale, eps):
        calls["rmsnorm"] += 1
        return fill(torch.empty(x.shape, dtype=x.dtype), rref.rmsnorm_ref(x, scale, eps))

    monkeypatch.setattr(fops.build, "on_cuda", lambda name, *ts: True)
    monkeypatch.setattr(fops, "launch", flash)
    monkeypatch.setattr(rops, "launch", norm)
    return calls


def test_remat_relaunches_the_kernels(fake_card):
    """Under remat dots and full the backward recomputes each repeat's
    forward, re-launching the attention and rmsnorm kernels into fresh
    outputs (a launch the dispatcher cannot see is never served from a
    cache): forward 2 flash + 5 rmsnorm, recompute 2 + 4 (the final norm
    lies outside the remat); the gradients equal remat none's bit for bit."""
    base = reduced()
    params = tmodel.init_params(base, seed=0, device="cpu")
    batch = ttrain.batch_to(stream(base, batch=2).next_batch(), "cpu")
    got = {}
    for remat, want in (("none", (2, 5)), ("dots", (4, 9)), ("full", (4, 9))):
        fake_card.update(flash=0, rmsnorm=0)
        loss, _, grads = ttrain.loss_and_grads(params, reduced(remat=remat), batch)
        assert (fake_card["flash"], fake_card["rmsnorm"]) == want, remat
        got[remat] = (loss, grads)
    for remat in ("dots", "full"):
        assert torch.equal(got[remat][0], got["none"][0])
        assert equal_trees(got[remat][1], got["none"][1])


# --------------------------------------------------------------------------
# On the card.
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def step_gate(new_card, new_cpu, grads_card, grads_cpu, tol, lr):
    """Updated params card against CPU, given the clipped gradients each
    step used.  Adam's first step g/(|g| + ε) has its largest slope
    ε/(|g| + ε)² near g = 0, so a gradient difference d moves an element's
    step by at most lr·d·ε/(max(|g| − d, 0) + ε)².  Every element where
    that is within a tenth of ``tol`` of the leaf's scale is held to
    ``tol``; every element is held to Adam's bound 2·lr.  Returns the count
    held to the bound only."""
    excluded = 0
    for a, b, h, g in zip(tmodel.tree_leaves(new_card), tmodel.tree_leaves(new_cpu),
                          tmodel.tree_leaves(grads_card), tmodel.tree_leaves(grads_cpu),
                          strict=True):
        a, b, h, g = (t.detach().cpu().double() for t in (a, b, h, g))
        scale = max(float(b.abs().max()), 1e-30)
        gap = (h - g).abs()
        moved = lr * gap * ADAM_EPS / ((g.abs() - gap).clamp(min=0) + ADAM_EPS) ** 2
        sure = moved <= 0.1 * tol * scale
        excluded += int((~sure).sum())
        diff = (a - b).abs()
        assert float((diff * sure).max()) / scale <= tol
        assert float(diff.max()) <= 2.05 * lr
    return excluded


@pytest.mark.gpu
@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_gpu_train_step_matches_the_cpu(cuda, arch):
    """One train step of each reduced architecture on the card (the
    kernels' forward, the plain backward) against the CPU: the loss 1e-4,
    every gradient within 1e-3 of its scale (as the LM gradient check),
    the updated params 1e-4 (step_gate)."""
    cfg = reduced(arch, remat="dots")
    opt = AdamW(lr=1e-3, weight_decay=0.01, grad_clip=1.0)
    host = stream(cfg, batch=2).next_batch()
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    out = {}
    for dev in (torch.device("cpu"), cuda):
        p = tmodel.tree_map(lambda a: a.to(dev), params)
        loss, _, grads = ttrain.loss_and_grads(p, cfg, ttrain.batch_to(host, dev))
        new, st = opt.update(grads, opt.init(p), p)
        # μ after one step is (1 − b1) times the clipped gradient.
        out[dev.type] = (loss, grads, new, tmodel.tree_map(lambda m: m / (1 - opt.b1), st.mu))
    close(out["cuda"][0], out["cpu"][0], 1e-4)
    for a, b in zip(tmodel.tree_leaves(out["cuda"][1]), tmodel.tree_leaves(out["cpu"][1])):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a.cpu() - b).abs().max()) / scale <= 1e-3
    step_gate(out["cuda"][2], out["cpu"][2], out["cuda"][3], out["cpu"][3], 1e-4, opt.lr)


@pytest.mark.gpu
def test_gpu_remat_and_launch_counts(cuda):
    """On the card, danube reduced in float32 (the CUDA-core attention
    instance): remat none, dots and full give the same loss and gradients
    bit for bit (the recompute runs the same kernels on the same inputs;
    chip_smoke.py's train phase holds the same at full width), and the
    launches per step are 2 flash + 5 rmsnorm forward plus 2 + 4 recomputed
    under remat."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rmsnorm import ops as rops

    params = tmodel.init_params(reduced(), seed=0, device=cuda)
    batch = ttrain.batch_to(stream(reduced(), batch=2).next_batch(), cuda)
    got = {}
    for remat, want in (("none", (2, 5)), ("dots", (4, 9)), ("full", (4, 9))):
        before = (fops.LAUNCHES["flash_attention"], rops.LAUNCHES["rmsnorm"])
        loss, _, grads = ttrain.loss_and_grads(params, reduced(remat=remat), batch)
        torch.cuda.synchronize(cuda)
        launched = (fops.LAUNCHES["flash_attention"] - before[0],
                    rops.LAUNCHES["rmsnorm"] - before[1])
        assert launched == want, (remat, launched)
        got[remat] = (loss, grads)
    for remat in ("dots", "full"):
        assert torch.equal(got[remat][0], got["none"][0])
        assert equal_trees(got[remat][1], got["none"][1])
