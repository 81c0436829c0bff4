"""PyTorch port, the observability layer (``repro_torch.obs``): registry,
buckets, percentiles, sinks, ``recording``, ``validate``, spans and tap
sampling — the counterparts of tests/test_obs.py — and, against the JAX
package, the same instrumented calls giving the same span paths, metric
names and label keys and the same deterministic counters.  Disabled, the
layer reads nothing from the device: one posterior call and one fit chunk
make as many host reads as with every obs entry point stubbed out.

JAX's ``test_span_noop_under_active_trace`` has no counterpart: the port
has no trace.  Its counterpart here is the profiler-only state: with obs
disabled under a recording torch profiler, a span is a profiler range and
nothing else.
"""
import contextlib
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop, obs, serving, solvers  # noqa: E402
from repro_torch.bo import thompson  # noqa: E402
from repro_torch.core import features, linops, modulation, walks  # noqa: E402
from repro_torch.gp import mll, posterior  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.obs import registry as obs_registry  # noqa: E402
from repro_torch.obs import report, spans, taps  # noqa: E402

CPU = "cpu"
SEED = 1214163296


@pytest.fixture(autouse=True)
def clean_obs(monkeypatch):
    """Every test starts disabled with an empty registry and no env flag."""
    monkeypatch.delenv("REPRO_OBS", raising=False)
    obs.reset_enabled()
    obs.REGISTRY.reset()
    yield
    obs.reset_enabled()
    obs.REGISTRY.reset()


@pytest.fixture()
def ring_sink():
    sink = obs.RingBufferSink(256)
    obs.REGISTRY.add_sink(sink)
    yield sink
    obs.REGISTRY.remove_sink(sink)


# ---------------------------------------------------------------------------
# Enablement, registry, buckets.
# ---------------------------------------------------------------------------


def test_enablement_resolution(monkeypatch):
    assert not obs.enabled()                      # default: off
    monkeypatch.setenv("REPRO_OBS", "1")
    obs.reset_enabled()                           # the env is read on reset
    assert obs.enabled()                          # env turns it on
    obs.disable()
    assert not obs.enabled()                      # global beats env
    obs.enable()
    assert obs.enabled()
    with obs.tap_scope(False):
        assert not obs.enabled()                  # context beats global
        with obs.tap_scope(True):
            assert obs.enabled()
        assert not obs.enabled()
    assert obs.enabled()


def test_env_var_is_read_on_import_and_reset_only(monkeypatch):
    """A disabled check reads no environment: ``REPRO_OBS`` is resolved
    when the module is imported and by ``reset_enabled``; a recording
    restores the resolved state on exit."""
    monkeypatch.setenv("REPRO_OBS", "1")
    assert not obs.enabled()                      # not read per check
    obs.reset_enabled()
    assert obs.enabled()
    monkeypatch.delenv("REPRO_OBS")
    assert obs.enabled()
    with obs.recording(None):
        assert obs.enabled()
    obs.disable()
    with obs.recording(None):
        assert obs.enabled()
    assert not obs.enabled()                      # the global restored
    obs.reset_enabled()
    assert not obs.enabled()


def test_module_conveniences_honour_switch():
    obs.inc("c")
    obs.gauge("g", 1.0)
    obs.observe("h", 1.0)
    snap = obs.REGISTRY.snapshot()
    assert not snap["counters"] and not snap["gauges"] and not snap["histograms"]
    obs.enable()
    obs.inc("c", 2)
    obs.gauge("g", 3.0)
    obs.observe("h", 0.5)
    snap = obs.REGISTRY.snapshot()
    assert snap["counters"]["c"] == 2
    assert snap["gauges"]["g"] == 3.0
    assert snap["histograms"]["h"]["count"] == 1


def test_label_key_folding():
    obs.enable()
    obs.inc("walks", labels={"scheme": "iid", "backend": "cpu"})
    obs.inc("walks", labels={"backend": "cpu", "scheme": "iid"})
    assert obs.REGISTRY.snapshot()["counters"] == {
        "walks{backend=cpu,scheme=iid}": 2}


def test_bucket_edges_are_fixed_log_spaced():
    edges = obs.log_buckets(1e-7, 1e3, 5)
    assert edges == obs.DEFAULT_BUCKETS
    assert len(edges) == 51
    assert edges[0] == pytest.approx(1e-7)
    assert edges[-1] == pytest.approx(1e3)
    ratios = [edges[i + 1] / edges[i] for i in range(len(edges) - 1)]
    assert all(r == pytest.approx(10 ** 0.2) for r in ratios)


def test_histogram_bucketing_edge_inclusive_with_overflow():
    h = obs.Histogram(buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 1.0, 10.0, 11.0, 1e6):
        h.observe(v)
    assert h.counts == [2, 1, 1, 1]
    assert h.count == 5
    assert h.total == pytest.approx(0.5 + 1.0 + 10.0 + 11.0 + 1e6)
    assert h.vmin == 0.5 and h.vmax == 1e6


def test_histogram_percentiles_clamped_and_monotone():
    h = obs.Histogram()
    h.observe(0.25)
    assert h.percentile(0.5) == h.percentile(0.99) == 0.25
    rng = np.random.default_rng(0)
    vals = rng.lognormal(mean=-5, sigma=2, size=500)
    for v in vals:
        h.observe(v)
    p50, p95, p99 = h.percentile(0.5), h.percentile(0.95), h.percentile(0.99)
    assert h.vmin <= p50 <= p95 <= p99 <= h.vmax
    exact = np.percentile(np.append(vals, 0.25), 95)
    assert p95 == pytest.approx(exact, rel=1.0)
    assert np.isnan(obs.Histogram().percentile(0.5))


def test_histogram_snapshot_fields():
    h = obs.Histogram()
    snap = h.snapshot()
    assert snap["count"] == 0 and snap["p50"] is None and snap["min"] is None
    h.observe(2.0)
    assert h.snapshot() == {"count": 1, "sum": 2.0, "min": 2.0, "max": 2.0,
                            "p50": 2.0, "p95": 2.0, "p99": 2.0}


def test_tap_tick_host_side_sampling():
    reg = obs.Registry()
    hits = [reg.tap_tick("x", 4) for _ in range(8)]
    assert hits == [True, False, False, False, True, False, False, False]
    assert all(reg.tap_tick("y", 1) for _ in range(3))


# ---------------------------------------------------------------------------
# Spans.
# ---------------------------------------------------------------------------


def test_span_nesting_and_ordering(ring_sink):
    obs.enable()
    with obs.span("outer") as sp:
        sp.note(fill=0.5)
        with obs.span("inner"):
            time.sleep(0.01)
    events = list(ring_sink.events)
    assert [e["name"] for e in events] == ["inner", "outer"]
    inner, outer = events
    assert inner["path"] == "outer/inner" and inner["depth"] == 1
    assert outer["path"] == "outer" and outer["depth"] == 0
    assert inner["seq"] < outer["seq"]
    assert outer["attrs"] == {"fill": 0.5}
    assert not inner["blocked"]
    assert outer["dur_s"] >= inner["dur_s"] >= 0.01
    snap = obs.REGISTRY.snapshot()
    assert snap["histograms"]["span.inner"]["count"] == 1
    assert snap["histograms"]["span.outer"]["count"] == 1


def test_span_block_on_records_blocked_flag(ring_sink):
    obs.enable()
    with obs.span("blocked") as sp:
        sp.block_on({"a": [torch.ones(8) * 2.0]})
    (ev,) = ring_sink.events
    assert ev["blocked"] is True


def test_span_block_finds_the_tensors_of_nested_values():
    tr = walks.WalkTrace(torch.zeros(2, 3, dtype=torch.int32),
                         torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.int32))
    found = spans._cuda_devices({"t": tr, "l": [torch.ones(1)], "n": 3}, set())
    assert found == set()         # CPU tensors: nothing to synchronize
    assert spans._cuda_devices(tr, set()) == set()


def test_span_disabled_is_noop(ring_sink):
    with obs.span("nope") as sp:
        sp.note(x=1)
        sp.block_on(torch.ones(2))
    assert not ring_sink.events
    assert not obs.REGISTRY.snapshot()["histograms"]


def test_enabled_span_is_a_profiler_range():
    obs.enable()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("obs.test_range"):
            torch.ones(4) + 1
    assert "obs.test_range" in {e.key for e in prof.key_averages()}


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _range_counts(prof) -> dict:
    return {e.key: e.count for e in prof.key_averages()}


def test_disabled_span_without_profiler_enters_no_range(monkeypatch,
                                                       ring_sink):
    """Obs and the profiler both off: the span never reaches
    ``record_function`` (which costs far more than the span's checks)."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with obs and the "
                             "profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with obs.span("obs.test_off", block=torch.ones(2)) as sp:
        sp.note(x=1)
        torch.ones(4) + 1
    assert sp is spans._NULL
    assert not ring_sink.events
    assert not any(obs.REGISTRY.snapshot().values())


def test_disabled_span_under_a_profiler_is_a_range_only(ring_sink):
    """Obs off under a recording profiler: the span's range is in the
    profile, and nothing reaches the registry or a sink."""
    with _cpu_profile() as prof:
        with obs.span("obs.test_profiled") as sp:
            sp.note(x=1)
            with obs.span("obs.test_inner"):
                torch.ones(4) + 1
    counts = _range_counts(prof)
    assert counts["obs.test_profiled"] == counts["obs.test_inner"] == 1
    assert not ring_sink.events
    assert not any(obs.REGISTRY.snapshot().values())


def test_profiler_only_span_never_blocks(monkeypatch):
    """``block=`` and ``block_on`` are ignored under the profiler alone: no
    synchronisation is attempted and nothing is read from the device."""
    def refuse(value):
        raise AssertionError("a profiler-only span blocked")

    monkeypatch.setattr(spans, "_block", refuse)
    x = torch.arange(8, dtype=torch.float32)
    with _cpu_profile() as prof, _count_reads() as counts:
        with obs.span("obs.test_block", block=x) as sp:
            sp.block_on({"y": [x * 2.0]})
    assert counts["n"] == 0
    assert _range_counts(prof)["obs.test_block"] == 1


def test_disabled_overhead_gate():
    """Min-of-N wall clock: a disabled span around a small op costs about
    what the bare op does (lenient: 2× + 20 µs, shared runners jitter)."""
    x = torch.arange(4096, dtype=torch.float32)

    def bare():
        return torch.cumsum(x * 2.0, 0)

    def inst():
        with obs.span("s"):
            out = torch.cumsum(x * 2.0, 0)
        taps.tap("t", out[-1])
        return out

    def best_of(fn, reps=50):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return min(ts)

    inst(), bare()
    assert best_of(inst) <= best_of(bare) * 2.0 + 2e-5


# ---------------------------------------------------------------------------
# Taps and counters.
# ---------------------------------------------------------------------------


class _Unreadable:
    """Stands in for a device value: any read of it fails the test."""

    def __array__(self, *a, **k):
        raise AssertionError("a disabled tap read its value")

    def item(self):
        raise AssertionError("a disabled tap read its value")


def test_disabled_taps_read_nothing():
    taps.tap("t", _Unreadable())
    taps.tap_dict("d", {"v": _Unreadable()}, hist=("v",))
    taps.count("c")
    snap = obs.REGISTRY.snapshot()
    assert not snap["counters"] and not snap["gauges"]


def test_tap_dict_kinds(ring_sink):
    obs.enable()
    taps.tap_dict("t", {"total": torch.tensor(3.0), "ok": torch.tensor(True),
                        "n": 4}, hist=("total",), meta={"k": "v"})
    snap = obs.REGISTRY.snapshot()
    assert snap["counters"]["t.count"] == 1 and snap["counters"]["t.ok"] == 1
    assert snap["histograms"]["t.total"]["count"] == 1
    assert snap["gauges"]["t.n"] == 4.0
    (ev,) = ring_sink.events
    assert ev["values"] == {"total": 3.0, "ok": True, "n": 4}
    assert ev["meta"] == {"k": "v"}


def test_tap_sampling_reads_every_kth_value_only():
    obs.enable()
    reads = []

    class Counted:
        def __init__(self, v):
            self.v = v

        def __array__(self, *a, **k):
            reads.append(self.v)
            return np.asarray(self.v)

    for i in range(10):
        taps.tap("s", Counted(float(i)), kind="hist", sample=4)
    assert reads == [0.0, 4.0, 8.0]
    assert obs.REGISTRY.snapshot()["histograms"]["s"]["count"] == 3


def test_count_counts_calls():
    obs.enable()
    for _ in range(3):
        taps.count("execs")
    assert obs.REGISTRY.snapshot()["counters"]["execs"] == 3


def test_walk_counters_and_span_on_the_cpu():
    """The walk sampler's counters carry {backend, scheme}; ``backend`` is
    the device type (the plain version here), and enabling obs does not
    change the trace."""
    g = generators.barabasi_albert(64, m=2, seed=0, device=CPU)
    t_off = walks.sample_walks(g, SEED, n_walkers=2, p_halt=0.5, l_max=3)
    assert not obs.REGISTRY.snapshot()["counters"]
    obs.enable()
    t_on = walks.sample_walks(g, SEED, n_walkers=2, p_halt=0.5, l_max=3)
    snap = obs.REGISTRY.snapshot()
    label = "{backend=cpu,scheme=iid}"
    assert snap["counters"][f"walks.rows_sampled{label}"] == 64
    assert snap["counters"][f"walks.walkers_launched{label}"] == 128
    assert snap["counters"][f"walks.sample_calls{label}"] == 1
    assert snap["histograms"]["span.walks.sample"]["count"] == 1
    assert torch.equal(t_off.cols, t_on.cols)
    assert torch.equal(t_off.loads, t_on.loads)


def _solver_problem():
    g = generators.ring(256, k=3, device=CPU)
    cfg = walks.WalkConfig(n_walkers=4, p_halt=0.3, l_max=4)
    tr = walks.sample_walks_for_nodes(g, torch.arange(32), SEED,
                                      cfg.n_walkers, cfg.p_halt, cfg.l_max)
    mod = modulation.diffusion(l_max=cfg.l_max)
    f = mod(mod.init(device=CPU))
    h = linops.shifted(tr, f, torch.tensor(1e-1), g.n_nodes)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(32)
                         .astype(np.float32))
    return h, b


def test_solver_tap_mirrors_cg_result(ring_sink):
    h, b = _solver_problem()
    obs.enable()
    strategy = solvers.SolveStrategy(tol=1e-6, max_iters=200,
                                     preconditioner="jacobi")
    res = solvers.solve(h, b, strategy)
    evs = [e for e in ring_sink.events
           if e["type"] == "tap" and e["name"] == "solver.cg"]
    assert evs, "solver.cg tap did not fire"
    ev = evs[-1]
    assert ev["values"]["iters"] == int(res.iters)
    assert ev["values"]["converged"] == bool(torch.all(res.converged))
    assert ev["values"]["resnorm_max"] == pytest.approx(
        float(torch.max(res.resnorm)))
    assert ev["meta"]["preconditioner"] == "jacobi"
    assert ev["meta"]["precond_rank"] == int(res.precond_rank)
    assert ev["meta"]["max_iters"] == 200
    assert obs.REGISTRY.snapshot()["histograms"]["solver.cg.iters"]["count"] == 1


@pytest.mark.parametrize("adaptive", [True, False])
def test_cg_residual_trajectory_every_8th_iteration(ring_sink, adaptive):
    h, b = _solver_problem()
    obs.enable()
    strategy = solvers.SolveStrategy(tol=1e-12, max_iters=20,
                                     preconditioner="none", adaptive=adaptive)
    res = solvers.solve(h, b, strategy)
    traj = [e["values"]["value"] for e in ring_sink.events
            if e["type"] == "tap" and e["name"] == "solver.cg.resnorm_traj"]
    # Iterations 1, 9 and 17 of 20: every 8th, from the first.
    assert res.iters == 20 and len(traj) == 3
    assert all(np.isfinite(traj)) and traj[-1] < traj[0]
    # The values are the recurrence's own residuals: CG with the same
    # stopping point recomputed without obs gives the same last one.
    obs.disable()
    res_off = solvers.solve(h, b, strategy.with_(max_iters=17))
    assert traj[-1] == pytest.approx(float(torch.max(res_off.resnorm)),
                                     rel=1e-6)


@pytest.mark.parametrize("adaptive", [True, False])
def test_cg_spans_under_a_profiler(adaptive):
    """The adaptive loop reads its stopping test once before each iteration
    and once more to stop (iterations + 1 reads, when it converges under its
    cap); the fixed loop reads nothing inside."""
    h, b = _solver_problem()
    strategy = solvers.SolveStrategy(tol=1e-4, max_iters=200,
                                     preconditioner="jacobi",
                                     adaptive=adaptive)
    with _cpu_profile() as prof:
        res = solvers.solve(h, b, strategy)
    counts = _range_counts(prof)
    assert 0 < res.iters < 200 if adaptive else res.iters == 200
    assert counts["solver.cg"] == 1
    assert counts["solver.cg.iter"] == res.iters
    assert counts.get("solver.cg.read", 0) == (res.iters + 1 if adaptive
                                               else 0)
    assert counts["linops.khat"] == res.iters


def test_column_index_span_counts_builds_only():
    """``walks.column_index`` is a build: the first K̂ product on a trace
    makes one, a second product reads the kept index."""
    g = generators.ring(256, k=3, device=CPU)
    tr = walks.sample_walks(g, SEED, n_walkers=4, p_halt=0.3, l_max=4)
    mod = modulation.diffusion(l_max=4)
    f = mod(mod.init(device=CPU))
    trace_x = features.take_rows(tr, torch.arange(0, 256, 8))
    k = linops.khat(trace_x, f, g.n_nodes)
    v = torch.ones(32, 2)
    with _cpu_profile() as prof:
        k.matvec(v)
    with _cpu_profile() as again:
        k.matvec(v)
    first, second = _range_counts(prof), _range_counts(again)
    assert first["walks.column_index"] == 1 and first["linops.khat"] == 1
    assert "walks.column_index" not in second and second["linops.khat"] == 1


def test_span_events_of_one_request_share_its_number(ring_sink):
    """Every span and tap under one ``pathwise_samples`` call carries the
    same ``request``; the next call carries the next one."""
    g = generators.ring(200, k=2, device=CPU)
    tr = walks.sample_walks(g, SEED, n_walkers=4, p_halt=0.3, l_max=3)
    mod = modulation.diffusion(l_max=3)
    f = mod(mod.init(device=CPU))
    rng = np.random.default_rng(0)
    train = torch.from_numpy(np.sort(rng.choice(200, 24, replace=False)))
    y = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    with obs.recording(None):
        for seed in (1, 2):
            posterior.pathwise_samples(tr, train, f, 0.1, y,
                                       torch.Generator().manual_seed(seed),
                                       n_samples=4)
    events = [e for e in ring_sink.events if e["type"] in ("span", "tap")]
    roots = [e for e in events if e["type"] == "span" and e["depth"] == 0]
    assert [e["name"] for e in roots] == ["posterior.pathwise"] * 2
    first, second = (e["request"] for e in roots)
    assert second == first + 1
    names = {e["name"] for e in events if e["type"] == "span"}
    assert set(spans.PORT_SPANS) - {"linops.phi_t"} <= names
    cut = events.index(roots[0]) + 1
    assert {e.get("request") for e in events[:cut]} == {first}
    assert {e.get("request") for e in events[cut:]} == {second}
    assert any(e["type"] == "tap" for e in events[:cut])


# ---------------------------------------------------------------------------
# Flight recorder.
# ---------------------------------------------------------------------------


def test_recording_roundtrip_schema(tmp_path):
    path = str(tmp_path / "run.jsonl")
    with obs.recording(path) as reg:
        assert reg is obs.REGISTRY and obs.enabled()
        obs.inc("c", 2)
        with obs.span("work"):
            taps.tap_dict("t", {"total": torch.tensor(1.0)}, hist=("total",))
    assert not obs.enabled()
    assert report.validate(path) == []
    events = report.read_events(path)
    assert events[0]["type"] == "meta"
    assert events[0]["spmv_backend"] == "by-device"
    assert events[0]["torch_version"] == torch.__version__
    assert events[-1]["type"] == "summary"
    assert [e["seq"] for e in events] == sorted(e["seq"] for e in events)
    assert {"meta", "span", "tap", "summary"} <= {e["type"] for e in events}
    metrics = events[-1]["metrics"]
    assert metrics["counters"]["c"] == 2
    assert metrics["histograms"]["span.work"]["count"] == 1
    table = report.summary(metrics)
    assert "work" in table and "c" in table


def test_recording_without_path_uses_ring_only(tmp_path):
    obs.REGISTRY.inc("stale", 9)
    with obs.recording(None) as reg:
        obs.inc("x")
    assert not list(tmp_path.iterdir())
    assert reg.snapshot()["counters"] == {"x": 1}


def test_validate_catches_violations(tmp_path, capsys):
    p = tmp_path / "bad.jsonl"
    p.write_text("")
    assert report.validate(str(p))
    p.write_text('{"type": "span", "name": "x"}\n')
    errs = report.validate(str(p))
    assert any("meta" in e for e in errs)
    assert any("summary" in e for e in errs)
    assert any("missing" in e for e in errs)
    p.write_text("not json\n")
    assert any("unparseable" in e for e in report.validate(str(p)))
    good = tmp_path / "good.jsonl"
    with obs.recording(str(good)):
        obs.inc("ok")
    assert report.main(["--validate", str(good)]) == 0
    assert report.main(["--validate", str(p)]) == 1
    assert report.main(["--summary", str(good)]) == 0
    assert "ok" in capsys.readouterr().out


def test_fit_step_events_recorded(tmp_path):
    g = generators.ring(128, k=2, device=CPU)
    cfg = walks.WalkConfig(n_walkers=4, p_halt=0.3, l_max=3)
    tr = walks.sample_walks_for_nodes(g, torch.arange(24), SEED,
                                      cfg.n_walkers, cfg.p_halt, cfg.l_max)
    mod = modulation.diffusion(l_max=cfg.l_max)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(24)
                         .astype(np.float32))
    path = str(tmp_path / "fit.jsonl")
    with obs.recording(path):
        mll.fit_hyperparams(tr, mod, y, g.n_nodes,
                            torch.Generator().manual_seed(1), steps=2, chunk=2)
    assert report.validate(path) == []
    fits = [e for e in report.read_events(path) if e["type"] == "fit_step"]
    assert [e["step"] for e in fits] == [1, 2]
    for ev in fits:
        assert np.isfinite(ev["loss"])
        assert ev["cg_iters"] >= 1
        assert isinstance(ev["cg_converged"], bool)


# ---------------------------------------------------------------------------
# Disabled obs adds no host read.
# ---------------------------------------------------------------------------

_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
          "__float__", "__index__")


@contextlib.contextmanager
def _count_reads():
    counts = {"n": 0}
    saved = {name: getattr(torch.Tensor, name) for name in _READS}

    def wrap(fn):
        def counted(self, *a, **k):
            counts["n"] += 1
            return fn(self, *a, **k)
        return counted

    for name, fn in saved.items():
        setattr(torch.Tensor, name, wrap(fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def _stub_obs(monkeypatch):
    """Replace every obs entry point the hot paths call by a no-op."""
    @contextlib.contextmanager
    def no_span(*a, **k):
        yield spans._NULL

    noop = lambda *a, **k: None  # noqa: E731
    monkeypatch.setattr(obs, "span", no_span)
    for name in ("inc", "gauge", "observe", "emit_event", "tap"):
        monkeypatch.setattr(obs, name, noop)
    monkeypatch.setattr(obs, "enabled", lambda: False)
    monkeypatch.setattr(obs_registry, "enabled", lambda: False)
    for name in ("tap", "tap_dict", "count"):
        monkeypatch.setattr(taps, name, noop)


def _reads_of_workload():
    g = generators.ring(200, k=2, device=CPU)
    tr = walks.sample_walks(g, SEED, n_walkers=4, p_halt=0.3, l_max=3)
    mod = modulation.diffusion(l_max=3)
    params = mll.init_hyperparams(mod, init_noise=0.3, device=CPU)
    f = mod(params["mod"]).detach()
    rng = np.random.default_rng(0)
    train = torch.from_numpy(np.sort(rng.choice(200, 24, replace=False)))
    y = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    with _count_reads() as counts:
        posterior.posterior_mean(tr, train, f, 0.1, y, cg_tol=1e-6)
        mll.fit_hyperparams(features.take_rows(tr, train), mod, y, 200,
                            torch.Generator().manual_seed(0), steps=2, chunk=2)
    return counts["n"]


def test_disabled_obs_adds_no_host_read(monkeypatch):
    assert not obs.enabled()
    with_obs = _reads_of_workload()
    _stub_obs(monkeypatch)
    stubbed = _reads_of_workload()
    assert with_obs == stubbed > 0
    monkeypatch.undo()
    # Enabled, the same workload does read more (the solve taps).
    obs.enable()
    assert _reads_of_workload() > stubbed


# ---------------------------------------------------------------------------
# Against the JAX package: the same calls record the same schema.
# ---------------------------------------------------------------------------


def _names(snapshot: dict) -> dict[str, set[str]]:
    """Metric names with the label values dropped: ``name{k1,k2}``."""
    def strip(key):
        if "{" not in key:
            return key
        name, inner = key[:-1].split("{", 1)
        return name + "{" + ",".join(kv.split("=")[0]
                                     for kv in inner.split(",")) + "}"

    return {kind: {strip(k) for k in snapshot[kind]}
            for kind in ("counters", "gauges", "histograms")}


def _total(counters: dict, name: str) -> float:
    return sum(v for k, v in counters.items()
               if k == name or k.startswith(name + "{"))


DETERMINISTIC = ("walks.rows_sampled", "walks.walkers_launched", "mll.steps",
                 "serving.observations", "bo.rounds")


def test_same_schema_as_the_jax_package(tmp_path):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import obs as jobs
    from repro import serving as jserving
    from repro.bo import thompson as jthompson
    from repro.core import features as jfeat
    from repro.core import linops as jlinops
    from repro.core import modulation as jmod
    from repro.core import walks as jwalks
    from repro.gp import mll as jmll
    from repro.gp import posterior as jpost
    from repro.graphs import generators as jgen
    from repro.obs import report as jreport

    n, cfg = 96, walks.WalkConfig(n_walkers=3, p_halt=0.3, l_max=3)
    rng = np.random.default_rng(0)
    train = np.sort(rng.choice(n, 12, replace=False)).astype(np.int32)
    y = rng.standard_normal(12).astype(np.float32)
    obj_true = rng.standard_normal(n).astype(np.float32)

    def objective(idx):
        return obj_true[np.asarray(idx)]

    jg = jgen.ring(n, k=2)
    tg = interop.graph_from_numpy(jg.neighbors, jg.weights, jg.deg, device=CPU)
    kw = dict(n_walkers=cfg.n_walkers, p_halt=cfg.p_halt, l_max=cfg.l_max)

    def jax_calls():
        key = jax.random.PRNGKey(0)
        tr = jwalks.sample_walks(jg, key, **kw)
        mod = jmod.diffusion(l_max=cfg.l_max)
        fit = jmll.fit_hyperparams(jfeat.take_rows(tr, jnp.asarray(train)), mod,
                                   jnp.asarray(y), n, key, steps=2, chunk=2)
        f, s2 = mod(fit.params["mod"]), jmll.noise_var(fit.params)
        jpost.posterior_mean(tr, jnp.asarray(train), f, s2, jnp.asarray(y))
        jpost.pathwise_samples(tr, jnp.asarray(train), f, s2, jnp.asarray(y),
                               key, n_samples=4)
        jlinops.phi(tr, f, n).rmatvec(jnp.ones((n,), jnp.float32))
        st = jserving.init_state(jg, key, f, s2, 16, cfg)
        st = jserving.observe_batch(st, train[:4], y[:4])
        st = jserving.observe(st, int(train[4]), float(y[4]))
        jserving.GPServeLoop(st, batch=8).run(
            [jserving.GPRequest(nodes=np.arange(6))])
        jthompson.thompson_sampling_incremental(
            jg, cfg, mod, objective, key, n_init=8, n_steps=1,
            refit_every=1, refit_steps=2, n_candidates=16)

    def port_calls():
        tr = walks.sample_walks(tg, SEED, **kw)
        mod = modulation.diffusion(l_max=cfg.l_max)
        fit = mll.fit_hyperparams(
            features.take_rows(tr, torch.from_numpy(train)), mod,
            torch.from_numpy(y), n, torch.Generator().manual_seed(0),
            steps=2, chunk=2)
        f, s2 = mod(fit.params["mod"]).detach(), mll.noise_var(fit.params).detach()
        t_train, t_y = torch.from_numpy(train), torch.from_numpy(y)
        posterior.posterior_mean(tr, t_train, f, s2, t_y)
        posterior.pathwise_samples(tr, t_train, f, s2, t_y,
                                   torch.Generator().manual_seed(1), n_samples=4)
        linops.phi(tr, f, n).rmatvec(torch.ones(n))
        st = serving.init_state(tg, SEED, f, s2, 16, cfg)
        st = serving.observe_batch(st, train[:4], y[:4])
        st = serving.observe(st, int(train[4]), float(y[4]))
        serving.GPServeLoop(st, batch=8).run(
            [serving.GPRequest(nodes=np.arange(6))])
        thompson.thompson_sampling_incremental(
            tg, cfg, mod, objective, 0, n_init=8, n_steps=1,
            refit_every=1, refit_steps=2, n_candidates=16)

    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    try:
        with jobs.recording(jpath):
            jax_calls()
    finally:
        jobs.reset_enabled()
        jobs.REGISTRY.reset()
    with obs.recording(tpath):
        port_calls()

    jev, tev = jreport.read_events(jpath), report.read_events(tpath)
    assert report.validate(tpath) == [] and jreport.validate(tpath) == []
    assert report.validate(jpath) == []
    # The port's own spans (spans.PORT_SPANS) are taken out of its paths
    # and histograms; each of them has to be in the record, so that the
    # declared set hides no other difference.
    port = set(spans.PORT_SPANS)

    def jax_paths(path):
        return "/".join(p for p in path.split("/") if p not in port)

    tspans = [e for e in tev if e["type"] == "span"]
    assert port <= {e["name"] for e in tspans}
    assert ({jax_paths(e["path"]) for e in tspans if e["name"] not in port}
            == {e["path"] for e in jev if e["type"] == "span"})
    assert ({e["type"] for e in tev} == {e["type"] for e in jev})
    jm, tm = jev[-1]["metrics"], tev[-1]["metrics"]
    tnames = _names(tm)
    own = {f"span.{name}" for name in port}
    assert own <= tnames["histograms"]
    tnames["histograms"] -= own
    assert tnames == _names(jm)
    for name in DETERMINISTIC:
        assert _total(tm["counters"], name) == _total(jm["counters"], name) > 0, name
    # The port's label values: the scheme, and the device type as backend.
    walk_keys = [k for k in tm["counters"] if k.startswith("walks.rows_sampled")]
    assert walk_keys == ["walks.rows_sampled{backend=cpu,scheme=iid}"]
    json.dumps(tev)


@pytest.mark.parametrize("driver, argv", [
    ("serve_gp", ["--nodes", "2000", "--observe", "20", "--queries", "64",
                  "--batch", "16", "--fit-steps", "2"]),
    ("bo_social_network", ["--nodes", "600", "--steps", "2", "--init", "20",
                           "--walkers", "4", "--candidates", "64"]),
])
def test_drivers_record_a_valid_flight_record(tmp_path, capsys, driver, argv):
    import importlib

    path = str(tmp_path / f"{driver}.jsonl")
    mod = importlib.import_module(f"repro_torch.examples.{driver}")
    if driver == "bo_social_network":   # a checkpoint directory of its own
        argv = argv + ["--ckpt", str(tmp_path / "ckpt")]
    mod.main(argv + ["--record", path, "--device", "cpu"])
    assert not obs.enabled()
    assert report.validate(path) == []
    events = report.read_events(path)
    spans_seen = {e["name"] for e in events if e["type"] == "span"}
    want = ({"serving.observe_batch", "serving.wave", "serving.refit_alpha",
             "mll.fit_chunk"} if driver == "serve_gp"
            else {"bo.draw", "serving.thompson_draw", "serving.ingest"})
    assert want <= spans_seen, spans_seen
    assert "flight record written to" in capsys.readouterr().out


@pytest.fixture()
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_gpu_span_blocks_on_the_card_and_labels_the_kernel(cuda, ring_sink):
    """On the card a blocked span synchronizes the trace's device, and the
    walk counters carry backend=cuda (the kernel's launches)."""
    obs.enable()
    g = generators.ring(4096, k=2, device=cuda)
    with obs.span("w") as sp:
        tr = walks.sample_walks(g, SEED, 4, 0.3, 3)
        sp.block_on(tr)
    assert spans._cuda_devices(tr, set()) == {tr.cols.device}
    ev = [e for e in ring_sink.events if e["type"] == "span" and e["name"] == "w"]
    assert ev and ev[0]["blocked"] is True
    counters = obs.REGISTRY.snapshot()["counters"]
    assert counters["walks.rows_sampled{backend=cuda,scheme=iid}"] == 4096


@pytest.mark.gpu
def test_gpu_disabled_obs_adds_no_host_read(cuda, monkeypatch):
    """The no-host-read check of the CPU test, with the kernels launched."""
    g = generators.ring(2000, k=2, device=cuda)
    tr = walks.sample_walks(g, SEED, n_walkers=4, p_halt=0.3, l_max=3)
    mod = modulation.diffusion(l_max=3)
    f = mod(mod.init(device=cuda))
    rng = np.random.default_rng(0)
    train = torch.from_numpy(np.sort(rng.choice(2000, 64, replace=False))).to(cuda)
    y = torch.from_numpy(rng.standard_normal(64).astype(np.float32)).to(cuda)

    def reads():
        with _count_reads() as counts:
            posterior.posterior_mean(tr, train, f, 0.1, y)
        return counts["n"]

    with_obs = reads()
    _stub_obs(monkeypatch)
    assert reads() == with_obs > 0
