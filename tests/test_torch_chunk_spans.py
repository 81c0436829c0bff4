"""PyTorch port: the chunked Φ products' walk sampling is a ``walks.sample``
span, one a chunk, as each block of ``walks.walk_chunks`` is.  Under a
recording profiler with obs disabled it is a profiler range alone; with
obs enabled it records the block's rows, scheme and first row; on the card
it adds no synchronisation while obs is disabled."""
import contextlib
import warnings

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import features, linops, modulation, walks  # noqa: E402
from repro_torch.gp import posterior  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402

SEED = 1214163296
CFG = walks.WalkConfig(n_walkers=4, p_halt=0.3, l_max=3)
N, CHUNK = 250, 64          # four chunks, the last one partial


@pytest.fixture(autouse=True)
def clean_obs(monkeypatch):
    monkeypatch.delenv("REPRO_OBS", raising=False)
    obs.reset_enabled()
    obs.REGISTRY.reset()
    yield
    obs.reset_enabled()
    obs.REGISTRY.reset()


def _problem(device="cpu"):
    g = generators.ring(N, k=2, device=device)
    mod = modulation.diffusion(l_max=CFG.l_max)
    f = mod(mod.init(device=device)).detach()
    u = torch.randn(N, 3, generator=torch.Generator().manual_seed(0)).to(device)
    return g, f, u


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e.name for e in prof.events()]


@pytest.mark.parametrize("product", ["phi", "phi_t", "diag"])
def test_one_walks_sample_range_per_chunk(product):
    g, f, u = _problem()
    kw = dict(cfg=CFG, chunk=CHUNK)
    call = {"phi": lambda: features.phi_matvec_chunked(g, f, u, SEED, **kw),
            "phi_t": lambda: features.phi_t_matvec_chunked(g, f, u, SEED, **kw),
            "diag": lambda: features.khat_diag_approx_chunked(g, f, SEED, **kw)}
    out, names = _profiled(call[product])
    assert names.count("walks.sample") == -(-N // CHUNK)
    assert not obs.REGISTRY.snapshot()["histograms"]
    assert torch.isfinite(out).all()


def test_chunked_posterior_samples_each_pass_and_the_training_rows():
    g, f, _ = _problem()
    train = torch.arange(5, N, 31)
    y = torch.randn(len(train), generator=torch.Generator().manual_seed(1))
    _, names = _profiled(lambda: posterior.pathwise_samples_chunked(
        g, train, f, 0.05, y, torch.Generator().manual_seed(2), SEED, CFG,
        chunk=CHUNK, n_samples=2))
    assert names.count("posterior.pathwise_chunked") == 1
    assert names.count("walks.sample") == 2 * -(-N // CHUNK) + 1


def test_enabled_span_records_rows_scheme_and_chunk_start():
    g, f, u = _problem()
    sink = obs.RingBufferSink(64)
    obs.REGISTRY.add_sink(sink)
    try:
        obs.enable()
        on = linops.chunked_phi(g, f, SEED, CFG, CHUNK).matvec(u)
    finally:
        obs.REGISTRY.remove_sink(sink)
    ev = [e for e in sink.events
          if e["type"] == "span" and e["name"] == "walks.sample"]
    assert [e["attrs"]["chunk_start"] for e in ev] == [0, 64, 128, 192]
    assert {e["attrs"]["rows"] for e in ev} == {CHUNK}
    assert {e["attrs"]["scheme"] for e in ev} == {"iid"}
    assert {e["path"] for e in ev} == {"linops.phi/walks.sample"}
    snap = obs.REGISTRY.snapshot()
    label = "{backend=cpu,scheme=iid}"
    assert snap["counters"][f"walks.rows_sampled{label}"] == 4 * CHUNK
    assert snap["counters"][f"walks.sample_calls{label}"] == 4
    obs.disable()
    off = linops.chunked_phi(g, f, SEED, CFG, CHUNK).matvec(u)
    assert torch.equal(on, off)


@pytest.fixture()
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _sync_warnings(fn) -> int:
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # The mode's own notice on first use ("Synchronization debug mode is a
    # prototype feature ...") is no synchronising call.
    return sum("called a synchronizing" in str(w.message) for w in caught)


@pytest.mark.gpu
def test_walks_sample_span_adds_no_sync_on_the_card(cuda, monkeypatch):
    """Obs disabled: one chunked Φu on the card makes as many synchronising
    calls as with ``obs.span`` replaced by a null context."""
    g, f, u = _problem(cuda)
    assert _sync_warnings(lambda: u.sum().item()) == 1  # the count sees one
    op = linops.chunked_phi(g, f, SEED, CFG, CHUNK)
    op.matvec(u)                                    # builds the kernels
    with_span = _sync_warnings(lambda: op.matvec(u))
    monkeypatch.setattr(obs, "span",
                        lambda *a, **k: contextlib.nullcontext(
                            obs.spans._NULL))
    without = _sync_warnings(lambda: op.matvec(u))
    assert with_span == without
