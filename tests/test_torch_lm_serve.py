"""PyTorch port, LM serving: ``launch/serve.py::ServeLoop`` against the JAX
package's loop on serve_batch.py's requests (reduced configs of the four
'attn'-only architectures and danube's GQA variant, the JAX parameters
carried across), the CPU example, and (marked ``gpu``) the full-width
h2o-danube-1.8b loop on the card.

Greedy tokens must be identical: argmax takes the first index on ties in
both frameworks, and the float32 logits agree to ~1e-6 of scale.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ["h2o-danube-1.8b", "gemma3-4b", "gemma3-12b", "gemma2-27b",
            "h2o-danube-1.8b/gqa"]


def _variant(registry, name, **overrides):
    arch, _, kind = name.partition("/")
    cfg = registry.reduce_config(registry.get_config(arch))
    if kind == "gqa":
        cfg = dataclasses.replace(cfg, n_kv_heads=2)
    return dataclasses.replace(cfg, **overrides)


def _requests(cls, vocab, n=6, prompt=8, new=16):
    """serve_batch.py's requests: ``n`` prompts of ``prompt`` tokens from
    default_rng(0)."""
    rng = np.random.default_rng(0)
    return [cls(prompt=rng.integers(0, vocab, prompt).astype(np.int32),
                max_new_tokens=new) for _ in range(n)]


@pytest.fixture
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", VARIANTS)
def test_serve_loop_tokens_identical_to_jax(name):
    """Both loops at batch 4, max_len 64, on six requests of 8 tokens (two
    waves: the second admits into freed slots), 16 greedy tokens each."""
    pytest.importorskip("jax")
    import jax

    from repro import configs as jconfigs
    from repro.launch import serve as jserve
    from repro.models import model as jmodel

    jcfg, tcfg = _variant(jconfigs, name), _variant(tconfigs, name)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = interop.model_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jreqs = _requests(jserve.Request, jcfg.vocab_size)
    treqs = _requests(tserve.Request, tcfg.vocab_size)
    jserve.ServeLoop(jcfg, jp, batch=4, max_len=64).run(jreqs)
    tserve.ServeLoop(tcfg, tp, batch=4, max_len=64).run(treqs)
    want = [r.generated for r in jreqs]
    got = [r.generated for r in treqs]
    assert all(len(g) == 16 for g in got)
    assert got == want


def test_serve_loop_rules():
    """The static-batch rules: a prompt of another length waits for the wave
    to drain, requests stop at max_len − 1, slots are spliced in place, and
    temperature sampling is reproducible from its generator."""
    cfg = _variant(tconfigs, "h2o-danube-1.8b")
    params = tmodel.init_params(cfg, seed=1, device="cpu")
    loop = tserve.ServeLoop(cfg, params, batch=2, max_len=16)
    cache_ids = [id(t) for t in tmodel.tree_leaves(loop.cache)]
    a = tserve.Request(prompt=np.arange(5, dtype=np.int32), max_new_tokens=50)
    b = tserve.Request(prompt=np.arange(7, dtype=np.int32), max_new_tokens=2)
    assert loop.admit(a)
    assert not loop.admit(b)           # another length joins no live wave
    loop.run([b])
    assert len(a.generated) == 16 - 1 - 5 + 1 and a.done
    assert len(b.generated) == 2 and b.done
    assert [id(t) for t in tmodel.tree_leaves(loop.cache)] == cache_ids
    # Matmul weights cast once to cfg.dtype, the norm scales kept f32.
    sp = tserve.serving_params(params, dataclasses.replace(cfg, dtype="bfloat16"))
    assert sp["embed"].dtype == torch.bfloat16
    assert sp["final_norm"].dtype == torch.float32
    assert sp["stages"][0]["L0"]["attn"]["norm"].dtype == torch.float32
    assert sp["stages"][0]["L0"]["mlp"]["down"].dtype == torch.bfloat16

    def sampled(seed):
        gen = torch.Generator().manual_seed(seed)
        lp = tserve.ServeLoop(cfg, params, batch=2, max_len=32, generator=gen)
        reqs = [tserve.Request(prompt=np.arange(6, dtype=np.int32),
                               max_new_tokens=10, temperature=1.5) for _ in range(2)]
        return [r.generated for r in lp.run(reqs)]

    assert sampled(3) == sampled(3)
    assert sampled(3) != sampled(4)


def test_serve_batch_example_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.examples.serve_batch",
                          "--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("request ")]
    assert len(lines) == 6
    assert all("generated 16 tokens" in ln for ln in lines)


@pytest.mark.gpu
def test_gpu_full_width_danube_serve(cuda):
    """h2o-danube-1.8b at its published width (24 layers, bf16) on the card,
    random weights from seed 0: two requests of 64 tokens, 8 greedy tokens
    each; the kernels ran (24 attention launches per prefill, none in
    decode; 49 norms per prefill and per step) and the first token is the
    argmax of the card's own forward pass."""
    cfg = tconfigs.get_config("h2o-danube-1.8b")
    params = tmodel.init_params(cfg, seed=0, device=cuda)
    loop = tserve.ServeLoop(cfg, params, batch=2, max_len=128)
    del params
    reqs = _requests(tserve.Request, cfg.vocab_size, n=2, prompt=64, new=8)
    dispatch.reset_launch_counts()
    loop.run(reqs)
    counts = dispatch.launch_counts()
    steps = 7                          # 1 token from each prefill, 7 decode steps
    assert counts["flash_attention"] == 2 * cfg.n_layers
    assert counts["rmsnorm"] == (2 + steps) * (2 * cfg.n_layers + 1)
    assert all(len(r.generated) == 8 for r in reqs)
    tok = torch.as_tensor(reqs[0].prompt[None], device=cuda).long()
    logits, _ = tmodel.forward(loop.params, cfg, tok)
    assert torch.isfinite(logits).all()
    assert int(torch.argmax(logits[0, -1])) == reqs[0].generated[0]
