"""PyTorch port, every architecture of the LM scaffold at its reduced size
(twins of test_models_smoke.py): forward, loss_fn and its gradients against
the JAX package, decode keeping the cache's structure, teacher-forced
decode against forward, and the analytic parameter count.

The port gets the JAX package's own initialised parameters
(``interop.model_params_from_numpy``); one JAX run per architecture
(forward, and loss_fn under value_and_grad) is shared through a
module-scoped fixture.  Tolerances, relative to the result's scale: 1e-4
for logits, the loss, each metric and each parameter's gradient (two
repeats of every layer kind in float32, summed in another order than
XLA's); decode against forward at the JAX test's rtol 1e-3 / atol 2e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

TOL = 1e-4
ARCHS = tconfigs.list_archs()
DECODE_ARCHS = ["gemma3-4b", "mamba2-2.7b", "zamba2-7b", "deepseek-v2-236b",
                "whisper-base", "moonshot-v1-16b-a3b"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, tol=TOL):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def make_batch(cfg, b=2, s=16, seed=0) -> dict:
    """test_models_smoke.py's batch, as numpy arrays."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
             "labels": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.n_enc_layers:
        batch["enc_input"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_vis_tokens:
        batch["vis_input"] = rng.standard_normal(
            (b, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
    return batch


def tbatch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def paths(tree, pre=""):
    """(JAX keystr path, leaf) of a nested dict/list, JAX's path spelling."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from paths(v, f"{pre}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from paths(v, f"{pre}[{i}]")
    else:
        yield pre, tree


def reduced(arch, **overrides):
    return dataclasses.replace(tconfigs.reduce_config(tconfigs.get_config(arch)),
                               **overrides)


@pytest.fixture(scope="module")
def jax_runs():
    """arch → (port cfg, port params, batch, JAX logits, loss, metrics,
    gradients by path); each architecture's JAX run made once."""
    pytest.importorskip("jax")
    import jax

    from repro import configs as jconfigs
    from repro.models import model as jmodel

    runs = {}

    def get(arch):
        if arch not in runs:
            jcfg = jconfigs.reduce_config(jconfigs.get_config(arch))
            jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
            batch = make_batch(jcfg)
            kw = {k: batch[k] for k in ("enc_input", "vis_input") if k in batch}
            logits, aux = jmodel.forward(jp, jcfg, batch["tokens"], **kw)
            (loss, metrics), grads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
                jp, jcfg, batch)
            flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                    jax.tree_util.tree_flatten_with_path(grads)[0]}
            tp = interop.model_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
            runs[arch] = (reduced(arch), tp, batch, np.asarray(logits), float(aux),
                          float(loss), {k: float(v) for k, v in metrics.items()}, flat)
        return runs[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(jax_runs, arch):
    """Logits [2, 16, V] and the MoE aux of forward, and loss_fn's total and
    each metric (ce, zloss, moe_aux): finite and equal to JAX's."""
    cfg, tp, batch, want_logits, want_aux, want_loss, want_m, _ = jax_runs(arch)
    tb = tbatch(batch)
    logits, aux = tmodel.forward(tp, cfg, tb["tokens"], enc_input=tb.get("enc_input"),
                                 vis_input=tb.get("vis_input"))
    assert logits.shape == (2, 16, cfg.vocab_size) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    close(logits, want_logits)
    close(aux, want_aux)
    loss, metrics = tmodel.loss_fn(tp, cfg, tb)
    assert np.isfinite(float(loss))
    close(loss, want_loss)
    assert sorted(metrics) == sorted(want_m) == ["ce", "moe_aux", "zloss"]
    for k, v in metrics.items():
        close(v, want_m[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax(jax_runs, arch):
    """torch.autograd through loss_fn against jax.value_and_grad: every
    parameter's gradient within 1e-4 of its own scale (a parameter with no
    gradient in the port, e.g. an expert no token reaches, is zero in JAX)."""
    cfg, tp, batch, *_, want = jax_runs(arch)
    params = tmodel.tree_map(lambda a: a.clone().requires_grad_(True), tp)
    loss, _ = tmodel.loss_fn(params, cfg, tbatch(batch))
    leaves = tmodel.tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    got = dict(paths(tmodel.tree_with_leaves(params, grads)))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        if g is None:
            assert not np.any(want[path]), path
        else:
            close(g, want[path])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_keeps_the_cache(arch):
    """One decode step from init_cache: logits [2, 1, V], finite, and the
    cache comes back with the same structure, shapes and dtypes (the same
    tensors, written in place)."""
    cfg = reduced(arch)
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    cache = tmodel.init_cache(cfg, batch=2, max_len=32, device="cpu")
    before = [(p, tuple(t.shape), t.dtype, t.data_ptr()) for p, t in paths(cache)]
    tok = torch.from_numpy(make_batch(cfg)["tokens"][:, :1])
    logits, cache2 = tmodel.decode_step(params, cache, cfg, tok, 0)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert [(p, tuple(t.shape), t.dtype, t.data_ptr()) for p, t in paths(cache2)] == before


def _decode_vs_forward(cfg, params, batch, npre=8):
    kw = {k: v for k, v in tbatch(batch).items() if k in ("enc_input", "vis_input")}
    tok = torch.from_numpy(batch["tokens"])
    s = tok.shape[1]
    full, _ = tmodel.forward(params, cfg, tok, **kw)
    pf, cache = tmodel.prefill(params, cfg, tok[:, :npre], max_len=s, **kw)
    np.testing.assert_allclose(_np(pf), _np(full[:, npre - 1]), rtol=1e-3, atol=2e-4)
    out = []
    for t in range(npre, s):
        lg, cache = tmodel.decode_step(params, cache, cfg, tok[:, t:t + 1], t)
        np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, t]), rtol=1e-3, atol=2e-4)
        out.append(lg)
    return cache, out


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_forward(arch):
    """Teacher-forced prefill(8) + 12 decode steps reproduce the full
    forward's logits (cache f32, capacity factor 8 so that no MoE token is
    dropped: a drop depends on the sequence length)."""
    cfg = reduced(arch, cache_dtype="float32", capacity_factor=8.0)
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    _decode_vs_forward(cfg, params, make_batch(cfg, b=1, s=20, seed=1))


def test_mla_absorb_matches_naive():
    """deepseek's absorbed decode gives the naive decode's logits."""
    cfg = reduced("deepseek-v2-236b", cache_dtype="float32", capacity_factor=8.0)
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    tok = torch.from_numpy(make_batch(cfg, b=1, s=16, seed=2)["tokens"])
    _, cache = tmodel.prefill(params, cfg, tok[:, :8], max_len=16)
    start = tmodel.tree_map(torch.clone, cache)
    naive, _ = tmodel.decode_step(params, cache, cfg, tok[:, 8:9], 8)
    absorbed, _ = tmodel.decode_step(params, start, dataclasses.replace(cfg, mla_absorb=True),
                                     tok[:, 8:9], 8)
    np.testing.assert_allclose(_np(naive), _np(absorbed), rtol=1e-4, atol=1e-4)


def test_moe_gather_impl_matches_einsum():
    """moonshot's logits under moe_impl gather equal einsum's (1e-4)."""
    cfg = reduced("moonshot-v1-16b-a3b", capacity_factor=8.0)
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    tok = torch.from_numpy(make_batch(cfg, b=2, s=24, seed=6)["tokens"])
    l1, _ = tmodel.forward(params, cfg, tok)
    l2, _ = tmodel.forward(params, dataclasses.replace(cfg, moe_impl="gather"), tok)
    np.testing.assert_allclose(_np(l1), _np(l2), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_analytic_matches_actual(arch):
    """The port's init has the analytic count within 2 % (the JAX test's
    bound), and exactly the JAX init's leaves: the same paths and shapes."""
    cfg = reduced(arch)
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    actual = sum(p.numel() for p in tmodel.tree_leaves(params))
    assert abs(actual - cfg.param_count()) / actual < 0.02, (actual, cfg.param_count())
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.models import model as jmodel

    jcfg = jconfigs.reduce_config(jconfigs.get_config(arch))
    shapes = jax.eval_shape(lambda: jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    want = {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {p: tuple(t.shape) for p, t in paths(params)} == want
