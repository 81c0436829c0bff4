"""PyTorch port, the LM scaffold's serving path: configs, forward, prefill
and teacher-forced decode against the JAX package, on the four 'attn'-only
architectures at their reduced size plus a GQA variant of danube (whose
reduced config has 4 query and 4 KV heads).

The port is fed the JAX package's own initialised parameters
(``interop.model_params_from_numpy``) and, for decode, the JAX prefill's
cache (``interop.cache_from_numpy``).  Tolerance, relative to the result's
scale: 1e-4 for float32 logits and caches (a dozen layers of float32
matmuls, softmaxes and norms summed in another order than XLA's).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

TOL = 1e-4
ATTN_ARCHS = ["h2o-danube-1.8b", "gemma3-4b", "gemma3-12b", "gemma2-27b"]
VARIANTS = ATTN_ARCHS + ["h2o-danube-1.8b/gqa"]
ALL_ARCHS = tconfigs.list_archs()
S = 32          # forward length: past the reduced window of 16
NPRE = 20       # prompt of the decode tests; 12 decode steps to S


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, tol=TOL):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def _variant(registry, name, **overrides):
    """The reduced config of ``name`` (``<arch>/gqa``: 2 KV heads) in one
    package's registry, with ``overrides``."""
    arch, _, kind = name.partition("/")
    cfg = registry.reduce_config(registry.get_config(arch))
    if kind == "gqa":
        cfg = dataclasses.replace(cfg, n_kv_heads=2)
    return dataclasses.replace(cfg, **overrides)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax

    from repro import configs as jconfigs
    from repro.models import model as jmodel

    params = {}

    def setup(name, **overrides):
        """(JAX cfg, port cfg, JAX params, port params) of a variant; the
        JAX parameters from PRNGKey(0), carried across."""
        jcfg = _variant(jconfigs, name, **overrides)
        tcfg = _variant(tconfigs, name, **overrides)
        if name not in params:
            jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
            params[name] = (jp, interop.model_params_from_numpy(
                jax.tree.map(np.asarray, jp), device="cpu"))
        return (jcfg, tcfg, *params[name])

    return jax, jmodel, jconfigs, setup


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, n)).astype(np.int32)


def _asdict(cfg):
    d = dataclasses.asdict(cfg)
    d["stages"] = [(r, [dataclasses.asdict(s) for s in p]) for r, p in cfg.stages]
    return d


def _layout(tree, path=""):
    """{path: (shape, dtype name)} of a nested dict/list of arrays or tensors."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _layout(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _layout(sub, f"{path}/{i}").items()}
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_match_jax(jx, arch):
    """The port's copy of every config, full and reduced, is the JAX one:
    every field, the analytic counts and the shape grid."""
    _, _, jconfigs, _ = jx
    from repro.models import config as jcfgmod
    from repro_torch.models import config as tcfgmod

    for fn in (lambda r, a: r.get_config(a),
               lambda r, a: r.reduce_config(r.get_config(a))):
        j, t = fn(jconfigs, arch), fn(tconfigs, arch)
        assert _asdict(t) == _asdict(j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert t.n_layers == j.n_layers and t.resolved_head_dim == j.resolved_head_dim
    assert tcfgmod.SHAPES == jcfgmod.SHAPES
    assert tconfigs.list_archs() == jconfigs.list_archs()


@pytest.mark.parametrize("name", VARIANTS)
def test_param_count_and_layout(jx, name):
    """Parameter count: JAX leaves == port leaves == the analytic count less
    one norm per layer plus the final norm (the analytic count gives an
    attention layer two norms and leaves the final one out); the port's own
    init has the JAX layout, shapes and dtypes leaf for leaf."""
    jax, _, _, setup = jx
    jcfg, tcfg, jp, tp = setup(name)
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    n_port = sum(t.numel() for t in tmodel.tree_leaves(tp))
    d = tcfg.d_model
    assert n_jax == n_port == tcfg.param_count() - (tcfg.n_layers - 1) * d
    own = tmodel.init_params(tcfg, seed=0, device="cpu")
    assert _layout(jax.tree.map(np.asarray, jp)) == _layout(own)
    # Same distributions: norms zero, weights truncated at 2 of their scale.
    emb = own["embed"]
    assert float(emb.abs().max()) <= 2 * tcfg.d_model**-0.5 + 1e-7
    assert abs(float(emb.std()) * tcfg.d_model**0.5 - 0.88) < 0.05
    assert float(own["final_norm"].abs().max()) == 0.0


@pytest.mark.parametrize("name", VARIANTS)
def test_forward_matches_jax(jx, name):
    _, jmodel, _, setup = jx
    jcfg, tcfg, jp, tp = setup(name)
    tok = _tokens(jcfg, S, 1)
    want, _ = jmodel.forward(jp, jcfg, tok)
    got, aux = tmodel.forward(tp, tcfg, torch.from_numpy(tok).long())
    assert got.dtype == torch.float32 and float(aux) == 0.0
    close(got, want)


@pytest.mark.parametrize("name", VARIANTS)
def test_prefill_matches_jax(jx, name):
    """Last-token logits and every cache leaf (window layers' ring buffers
    hold the last 16 of 20 positions, wrapped)."""
    jax, jmodel, _, setup = jx
    jcfg, tcfg, jp, tp = setup(name, cache_dtype="float32")
    tok = _tokens(jcfg, NPRE, 2)
    want_l, want_c = jmodel.prefill(jp, jcfg, tok, max_len=S)
    got_l, got_c = tmodel.prefill(tp, tcfg, torch.from_numpy(tok).long(), max_len=S)
    close(got_l, want_l)
    wl, gl = jax.tree.leaves(want_c), tmodel.tree_leaves(got_c)
    assert len(wl) == len(gl) > 0
    for w, g in zip(wl, gl):
        close(g, w)


@pytest.mark.parametrize("name", VARIANTS)
def test_decode_matches_jax(jx, name):
    """12 teacher-forced decode steps from the JAX prefill's cache: logits
    and cache at every step (positions 20..31 wrap the 16-slot ring)."""
    jax, jmodel, _, setup = jx
    jcfg, tcfg, jp, tp = setup(name, cache_dtype="float32")
    tok = _tokens(jcfg, S, 3)
    jdecode = jax.jit(jmodel.decode_step, static_argnums=(2,))
    _, jcache = jmodel.prefill(jp, jcfg, tok[:, :NPRE], max_len=S)
    tcache = interop.cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    for t in range(NPRE, S):
        want_l, jcache = jdecode(jp, jcache, jcfg, tok[:, t:t + 1], np.int32(t))
        got_l, tcache = tmodel.decode_step(tp, tcache, tcfg,
                                           torch.from_numpy(tok[:, t:t + 1]).long(), t)
        close(got_l, want_l)
        for w, g in zip(jax.tree.leaves(jcache), tmodel.tree_leaves(tcache)):
            close(g, w)


@pytest.mark.parametrize("name", VARIANTS)
def test_decode_matches_forward(jx, name):
    """The port alone: teacher-forced prefill + decode reproduces the
    full-sequence logits (as the JAX package's test_decode_matches_forward)."""
    _, _, _, setup = jx
    _, tcfg, _, tp = setup(name, cache_dtype="float32")
    tok = torch.from_numpy(_tokens(tcfg, S, 4)).long()
    full, _ = tmodel.forward(tp, tcfg, tok)
    npre = 8
    pf, cache = tmodel.prefill(tp, tcfg, tok[:, :npre], max_len=S)
    close(pf, full[:, npre - 1])
    for t in range(npre, S):
        lg, cache = tmodel.decode_step(tp, cache, tcfg, tok[:, t:t + 1], t)
        close(lg[:, 0], full[:, t])


def test_pallas_attention_path_matches_port(jx):
    """JAX with use_pallas_attn=True (the Pallas kernel in interpret mode)
    against the port on the CPU (the plain versions), danube and its GQA
    variant: forward logits and prefill logits."""
    _, jmodel, _, setup = jx
    for name in ("h2o-danube-1.8b", "h2o-danube-1.8b/gqa"):
        jcfg, tcfg, jp, tp = setup(name, use_pallas_attn=True)
        tok = _tokens(jcfg, S, 5)
        want, _ = jmodel.forward(jp, jcfg, tok)
        got, _ = tmodel.forward(tp, tcfg, torch.from_numpy(tok).long())
        close(got, want)
        want_l, _ = jmodel.prefill(jp, jcfg, tok[:, :NPRE], max_len=S)
        got_l, _ = tmodel.prefill(tp, tcfg, torch.from_numpy(tok[:, :NPRE]).long(), max_len=S)
        close(got_l, want_l)


def test_chunked_attention_impl_matches_jax(jx):
    """attn_impl='chunked' selects mha_chunked_ref on the CPU: gemma2-27b
    (window + softcap) with KV blocks of 8, against the JAX chunked path."""
    _, jmodel, _, setup = jx
    jcfg, tcfg, jp, tp = setup("gemma2-27b", attn_impl="chunked", attn_block_k=8)
    tok = _tokens(jcfg, S, 6)
    want, _ = jmodel.forward(jp, jcfg, tok)
    got, _ = tmodel.forward(tp, tcfg, torch.from_numpy(tok).long())
    close(got, want)


def test_bf16_activations_follow_jax(jx):
    """The default bf16 activation and cache dtypes on danube's reduced
    config: the √d_model scale rounds in bf16 (as JAX's) and prefill logits
    agree to bf16 precision (2e-2 of scale)."""
    _, jmodel, _, setup = jx
    jcfg, tcfg, jp, tp = setup("h2o-danube-1.8b", dtype="bfloat16")
    assert tcfg.cache_dtype == "bfloat16"
    tok = _tokens(jcfg, NPRE, 7)
    want_l, want_c = jmodel.prefill(jp, jcfg, tok, max_len=S)
    got_l, got_c = tmodel.prefill(tp, tcfg, torch.from_numpy(tok).long(), max_len=S)
    close(got_l, want_l, tol=2e-2)
    leaf = tmodel.tree_leaves(got_c)[0]
    assert leaf.dtype == torch.bfloat16
    big = _variant(tconfigs, "h2o-danube-1.8b", dtype="bfloat16", d_model=2560)
    x = tmodel._embed({"embed": torch.ones((3, 2560))}, big, torch.zeros((1, 1)).long())
    assert float(x[0, 0, 0]) == 50.5


def test_unported_kinds_raise():
    """Nothing is left unported: every layer kind inits, and with
    cfg.sp_attn set (activation sharding, ported with the sharding rules)
    forward, prefill and the cache raise nothing and, with no activation
    mesh registered, compute exactly what they compute without it."""
    for arch in ("deepseek-v2-236b", "moonshot-v1-16b-a3b", "mamba2-2.7b",
                 "zamba2-7b", "llama-3.2-vision-11b", "whisper-base",
                 "h2o-danube-1.8b"):
        base = tconfigs.reduce_config(tconfigs.get_config(arch))
        cfg = dataclasses.replace(base, sp_attn=True)
        params = tmodel.init_params(cfg, device="cpu")
        tok = torch.zeros((1, 4)).long()
        for run in (lambda c: tmodel.forward(params, c, tok)[0],
                    lambda c: tmodel.prefill(params, c, tok, max_len=8)[0],
                    lambda c: tmodel.init_cache(c, 1, 8, device="cpu")):
            assert_same = torch.testing.assert_close
            assert_same(run(cfg), run(base), rtol=0, atol=0)


# The gradient check of the card's kernels: danube at a narrow width (2
# layers, d_model 256), float32.  Tolerance: each parameter's gradient
# within 1e-3 of its own scale (two layers of float32 forward through the
# kernels, whose sums run in another order than the plain versions', then
# the same plain backward on both devices).
GRAD_TOL = 1e-3


@pytest.fixture
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _next_token_grads(params, cfg, tokens):
    """Gradients of the mean next-token cross-entropy of ``forward``'s
    logits with respect to every parameter (None where none flows)."""
    leaves = tmodel.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    logits, _ = tmodel.forward(params, cfg, tokens)
    loss = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.mark.gpu
def test_gpu_forward_gradients_match_the_cpu(cuda):
    """Autograd through ``forward`` on the card (rmsnorm and flash_attention
    on their kernels) gives every parameter the gradient the CPU (plain
    versions) gives it, within GRAD_TOL of that gradient's scale.  Launches:
    2 flash and 5 rmsnorm in the forward, and under danube's remat "dots"
    2 and 4 more where the backward recomputes each layer's body."""
    from repro_torch import configs as cfgs

    cfg = dataclasses.replace(
        cfgs.get_config("h2o-danube-1.8b"), dtype="float32", cache_dtype="float32",
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=1000,
        stages=((2, cfgs.get_config("h2o-danube-1.8b").stages[0][1]),))
    params = tmodel.init_params(cfg, seed=3, device=cuda)
    tok = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 64)))
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rmsnorm import ops as rops
    before = (fops.LAUNCHES["flash_attention"], rops.LAUNCHES["rmsnorm"])
    card_loss, card = _next_token_grads(params, cfg, tok.to(cuda))
    assert cfg.remat == "dots"
    assert fops.LAUNCHES["flash_attention"] - before[0] == 2 + 2
    assert rops.LAUNCHES["rmsnorm"] - before[1] == 5 + 4
    host = tmodel.tree_map(lambda a: a.detach().cpu(), params)
    cpu_loss, want = _next_token_grads(host, cfg, tok)
    close(card_loss, cpu_loss, GRAD_TOL)
    assert len(card) == len(want)
    for i, (c, w) in enumerate(zip(card, want)):
        assert (c is None) == (w is None), f"parameter {i}: gradient on one device only"
        if w is not None:
            close(c, w, GRAD_TOL)
