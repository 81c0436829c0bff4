"""PyTorch port, the LM scaffold's other layer kinds, module by module
against the JAX package: MLA (forward, prefill, naive and absorbed decode),
MoE (einsum and gather routing, the aux loss, shared experts), the Mamba2
SSD scan and its O(1) decode, cross-attention with the encoder, the vision
stub and the shared attention block.

Each module gets the JAX package's own parameters (``init_*`` from a
PRNGKey, carried across with ``interop.model_params_from_numpy``) and the
same numpy inputs, at the reduced configs (d_model 64), float32.
Tolerance, relative to the result's scale: 1e-5 for one module (a few
float32 matmuls and a softmax or a scan summed in another order than
XLA's), 1e-4 through the encoder or a whole model.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import LayerSpec  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = 1e-5
MODEL_TOL = 1e-4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, tol=TOL):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def _cfgs(arch, **overrides):
    from repro import configs as jconfigs

    j = dataclasses.replace(jconfigs.reduce_config(jconfigs.get_config(arch)), **overrides)
    t = dataclasses.replace(tconfigs.reduce_config(tconfigs.get_config(arch)), **overrides)
    return j, t


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax

    from repro.models import layers as jlayers

    def params(init, cfg, seed=0):
        """(JAX params of ``init(KeyGen, cfg)``, the port's copy)."""
        jp = init(jlayers.KeyGen(jax.random.PRNGKey(seed)), cfg)
        return jp, interop.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                                   device="cpu")

    return jax, params


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_mla_forward_prefill_and_both_decodes(jx):
    """mla_forward, mla_prefill (output and latent cache) and one decode
    step from the JAX prefill's cache, naive and absorbed (the two decode
    forms also against each other, as test_mla_absorb_matches_naive)."""
    jax, params = jx
    from repro.models import mla as jmla

    jcfg, tcfg = _cfgs("deepseek-v2-236b", cache_dtype="float32")
    jp, tp = params(jmla.init_mla, jcfg)
    x = _x((2, 12, jcfg.d_model), 1)
    pos = np.arange(12)
    close(tmla.mla_forward(tp, _t(x), tcfg, _t(pos)), jmla.mla_forward(jp, x, jcfg, pos))
    jout, jcache = jmla.mla_prefill(jp, x[:, :8], jcfg, pos[:8], 16)
    tout, tcache = tmla.mla_prefill(tp, _t(x[:, :8]), tcfg, _t(pos[:8]), 16)
    close(tout, jout)
    for k in ("c_kv", "k_rope"):
        close(tcache[k], jcache[k])
    outs = {}
    for absorb in (False, True):
        jc, tc = (dataclasses.replace(c, mla_absorb=absorb) for c in (jcfg, tcfg))
        want, want_c = jmla.mla_decode(jp, x[:, 8:9], jcache, jc, 8)
        start = interop.cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
        got, got_c = tmla.mla_decode(tp, _t(x[:, 8:9]), start, tc, 8)
        close(got, want)
        for k in ("c_kv", "k_rope"):
            close(got_c[k], want_c[k])
        outs[absorb] = got
    close(outs[True], outs[False], 1e-4)


# Seeds of the MoE inputs, chosen so that every token's k-th and (k+1)-th
# router probabilities differ by more than MARGIN: top-k is discontinuous,
# and a gap under the two packages' float32 difference could flip a choice.
MOE_SEED = 3
MARGIN = 1e-4


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v2-236b"])
def test_moe_routing_both_impls_and_aux(jx, arch):
    """Routing first (gate_idx equal to JAX's lax.top_k, the router margin
    above MARGIN), then moe_forward's output and aux loss for the einsum and
    gather impls against JAX and against each other (1e-4, the twin of
    test_moe_gather_impl_matches_einsum); capacity 1.25 drops tokens at S =
    24, and both impls drop the same ones."""
    jax, params = jx
    import jax.numpy as jnp

    from repro.models import layers as jlayers
    from repro.models import moe as jmoe

    jcfg, tcfg = _cfgs(arch)
    jp, tp = params(jmoe.init_moe, jcfg)
    x = _x((2, 24, jcfg.d_model), MOE_SEED)
    xn = _t(np.asarray(jlayers.rms_norm(x, jp["norm"])))
    probs, _, idx = tmoe.route(tp, xn, tcfg)
    top = torch.sort(probs, dim=-1, descending=True).values
    assert float((top[..., tcfg.top_k - 1] - top[..., tcfg.top_k]).min()) > MARGIN
    jprobs = jax.nn.softmax((jnp.asarray(_np(xn)) @ jp["router"]).astype(jnp.float32), -1)
    np.testing.assert_array_equal(_np(idx), np.asarray(jax.lax.top_k(jprobs, tcfg.top_k)[1]))
    assert tmoe.capacity(tcfg, 24) < 24 * tcfg.top_k / tcfg.n_experts * 2  # drops happen
    got = {}
    for impl in ("einsum", "gather"):
        jc, tc = (dataclasses.replace(c, moe_impl=impl) for c in (jcfg, tcfg))
        want_y, want_aux = jmoe.moe_forward(jp, x, jc)
        y, aux = tmoe.moe_forward(tp, _t(x), tc)
        close(y, want_y)
        close(aux, want_aux)
        got[impl] = y
    close(got["gather"], got["einsum"], 1e-4)


def _sequential_ssd(xh, dt, a, bm, cm):
    """The SSD recurrence step by step in float64: S_t = S_{t-1}·exp(dt_t·a)
    + B_t ⊗ (x_t·dt_t), y_t = C_t·S_t."""
    b, s, h, p = xh.shape
    state = np.zeros((b, h, bm.shape[-1], p))
    ys = np.zeros((b, s, h, p))
    for t in range(s):
        decay = np.exp(dt[:, t] * a)                                   # [B,H]
        state = state * decay[:, :, None, None] + np.einsum(
            "bn,bhp->bhnp", bm[:, t], xh[:, t] * dt[:, t, :, None])
        ys[:, t] = np.einsum("bn,bhnp->bhp", cm[:, t], state)
    return ys, state


def test_ssd_scan_against_jax_and_the_recurrence(jx):
    """_ssd_chunk_scan over 21 steps in chunks of 8 (a padded last chunk):
    y and the final state against JAX's chunked scan and against the
    sequential recurrence in float64."""
    _, _ = jx
    from repro.models import ssm as jssm

    b, s, h, p, n = 2, 21, 3, 4, 5
    xh = _x((b, s, h, p), 11)
    dt = np.log1p(np.exp(_x((b, s, h), 12) - 1.0)).astype(np.float32)
    a = -np.linspace(1.0, 4.0, h).astype(np.float32)
    bm, cm = _x((b, s, n), 13), _x((b, s, n), 14)
    y, state = tssm._ssd_chunk_scan(*map(_t, (xh, dt, a, bm, cm)), 8)
    jy, jstate = jssm._ssd_chunk_scan(xh, dt, a, bm, cm, 8)
    close(y, jy)
    close(state, jstate)
    sy, sstate = _sequential_ssd(*(v.astype(np.float64) for v in (xh, dt, a, bm, cm)))
    close(y, sy)
    close(state, sstate)


def test_mamba_forward_state_and_decode(jx):
    """mamba_forward(return_state=True) (output, conv and SSM state) and
    three O(1) mamba_decode steps continuing from it, against JAX; the
    decode also against the forward over the longer sequence (1e-4)."""
    jax, params = jx
    from repro.models import ssm as jssm

    jcfg, tcfg = _cfgs("mamba2-2.7b")
    jp, tp = params(jssm.init_mamba, jcfg)
    x = _x((2, 13, jcfg.d_model), 21)
    jout, jcache = jssm.mamba_forward(jp, x[:, :10], jcfg, return_state=True)
    tout, tcache = tssm.mamba_forward(tp, _t(x[:, :10]), tcfg, return_state=True)
    close(tout, jout)
    for k in ("conv", "ssm"):
        close(tcache[k], jcache[k])
    full = tssm.mamba_forward(tp, _t(x), tcfg)
    for t in range(10, 13):
        want, jcache = jssm.mamba_decode(jp, x[:, t:t + 1], jcache, jcfg)
        got, tcache = tssm.mamba_decode(tp, _t(x[:, t:t + 1]), tcache, tcfg)
        close(got, want)
        for k in ("conv", "ssm"):
            close(tcache[k], jcache[k])
        close(got, full[:, t:t + 1], MODEL_TOL)


def test_cross_attention_and_the_encoder(jx):
    """whisper's pieces: the encoder (non-causal attention layers and a
    final norm over the frame stub, 1e-4), then a cross-attention layer
    over its output — forward, prefill with its enc_seq-long cache, and a
    decode step that reads the cache as it is."""
    jax, _ = jx
    from repro.models import attention as jattn
    from repro.models import model as jmodel

    jcfg, tcfg = _cfgs("whisper-base", cache_dtype="float32")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = interop.model_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    enc = _x((2, jcfg.enc_seq, jcfg.d_model), 31)
    want_enc = jmodel._encode(jp, jcfg, enc)
    got_enc = tmodel._encode(tp, tcfg, _t(enc))
    close(got_enc, want_enc, MODEL_TOL)
    spec = LayerSpec(kind="cross_attn")
    jl = jax.tree.map(lambda a: a[0], jp["stages"][0]["L1"]["attn"])
    tl = tmodel._reps(tp["stages"][0], 2)[0]["L1"]["attn"]
    x = _x((2, 9, jcfg.d_model), 32)
    pos = np.arange(9)
    e = np.asarray(want_enc)
    close(tattn.attn_forward(tl, _t(x), tcfg, spec, _t(pos), enc_out=_t(e)),
          jattn.attn_forward(jl, x, jcfg, spec, pos, enc_out=e))
    want, jcache = jattn.attn_prefill(jl, x, jcfg, spec, pos, 16, enc_out=e)
    got, tcache = tattn.attn_prefill(tl, _t(x), tcfg, spec, _t(pos), 16, enc_out=_t(e))
    close(got, want)
    assert tcache["k"].shape == (2, jcfg.n_kv_heads, jcfg.enc_seq, jcfg.resolved_head_dim)
    for k in ("k", "v"):
        close(tcache[k], jcache[k])
    before = {k: v.clone() for k, v in tcache.items()}
    want, _ = jattn.attn_decode(jl, x[:, :1], jcache, jcfg, spec, 9)
    got, out_cache = tattn.attn_decode(tl, _t(x[:, :1]), tcache, tcfg, spec, 9)
    close(got, want)
    assert all(torch.equal(out_cache[k], before[k]) for k in before)


def test_vision_stub_and_shared_attention(jx):
    """llama-3.2-vision's patch-embedding stub is the cross-attention memory
    as it is (forward against JAX; the logits move with vis_input), and
    zamba2's shared block is one set of tensors applied at every
    shared_attn slot (the same tensor objects at each call; forward and the
    shared block's gradient against JAX)."""
    jax, _ = jx
    from repro.models import model as jmodel

    jcfg, tcfg = _cfgs("llama-3.2-vision-11b")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = interop.model_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tok = np.random.default_rng(41).integers(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    vis = _x((2, jcfg.n_vis_tokens, jcfg.d_model), 42)
    got, _ = tmodel.forward(tp, tcfg, _t(tok), vis_input=_t(vis))
    close(got, jmodel.forward(jp, jcfg, tok, vis_input=vis)[0], MODEL_TOL)
    other, _ = tmodel.forward(tp, tcfg, _t(tok), vis_input=_t(vis + 1.0))
    assert float((other - got).abs().max()) > 1e-3

    jcfg, tcfg = _cfgs("zamba2-7b")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = interop.model_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert "shared" in tp and tp["stages"][0]["L5"] == {}
    seen = []
    real = tattn.attn_forward

    def spy(p, x, cfg, spec, positions, enc_out=None):
        if spec.kind == "shared_attn":
            seen.append(id(p["wq"]))
        return real(p, x, cfg, spec, positions, enc_out)

    tattn.attn_forward = spy
    try:
        for leaf in tmodel.tree_leaves(tp["shared"]):
            leaf.requires_grad_(True)
        logits, _ = tmodel.forward(tp, tcfg, _t(tok))
    finally:
        tattn.attn_forward = real
    assert seen == [id(tp["shared"]["attn"]["wq"])] * 2   # 2 repeats x 1 slot
    want, _ = jmodel.forward(jp, jcfg, tok)
    close(logits, want, MODEL_TOL)
    g = torch.autograd.grad(logits.square().mean(), tp["shared"]["attn"]["wq"])[0]
    jg = jax.grad(lambda p: jmodel.forward(p, jcfg, tok)[0].__pow__(2).mean())(jp)
    close(g, jg["shared"]["attn"]["wq"], MODEL_TOL)
