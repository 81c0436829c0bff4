"""PyTorch port, the write-ahead journal, crash recovery and the journalled
server (``repro_torch.resilience.journal`` / ``.server``), the counterparts
of the journal and recovery tests in tests/test_resilience.py, and the
resilience paths of the two driver twins.

Against the JAX package: a journal that either package writes replays in
the other, and the recovered moments agree with the other package's live
state to 1e-4 of scale.  Within the port, recovery from checkpoint +
journal tail matches the live state (and an uninterrupted run, after a
hard kill in a child process) to 1e-5, as the JAX tests hold it; the
async fleet killed between its write-ahead record and its dispatch
recovers to the journalled fold bit for bit, as JAX's fleet test holds it.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs, serving  # noqa: E402
from repro_torch.bo import thompson  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import modulation, walks  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.resilience import (  # noqa: E402
    KILL_EXIT_CODE, Journal, ResilientServer, faults, read_journal, recover)

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
CFG = walks.WalkConfig(n_walkers=6, p_halt=0.25, l_max=4)
S2 = 0.05
CAPACITY = 16
SEED = 1214163296


@pytest.fixture(autouse=True)
def clean_faults(monkeypatch):
    monkeypatch.delenv("REPRO_FAULTS", raising=False)
    faults.reset_faults()
    obs.reset_enabled()
    obs.REGISTRY.reset()
    yield
    faults.reset_faults()
    obs.reset_enabled()
    obs.REGISTRY.reset()


def close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().cpu().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def empty_state(device=CPU, capacity=CAPACITY):
    g = generators.grid2d(10, 10, device=device)
    mod = modulation.diffusion(l_max=CFG.l_max)
    f = mod(mod.init(torch.Generator().manual_seed(1), device=device))
    return serving.init_state(g, SEED, f, S2, capacity, CFG)


@pytest.fixture(scope="module")
def empty():
    return empty_state()


def test_journal_roundtrip_and_torn_tail(tmp_path):
    path = str(tmp_path / "j.jsonl")
    with Journal(path) as j:
        assert j.log("observe", nodes=[1], ys=[0.5]) == 0
        assert j.log("forget", slot=0) == 1
        with pytest.raises(ValueError, match="unknown journal event"):
            j.log("mutate")
    with open(path, "a") as fh:
        fh.write('{"t": 1, "seq": 2, "type": "obse')   # torn tail write
    events = read_journal(path)
    assert [e["seq"] for e in events] == [0, 1]        # tail dropped
    with Journal(path) as j2:                          # seq resumes
        assert j2.log("observe", nodes=[2], ys=[1.0]) == 2
    with open(path, "a") as fh:
        fh.write('{"broken\n{"t": 1, "seq": 4, "type": "forget", "slot": 0}\n')
    with pytest.raises(ValueError):                    # mid-log damage raises
        read_journal(path)


def _ops(srv, rng):
    srv.observe([1, 2, 3], rng.standard_normal(3))
    srv.observe(torch.tensor([4, 5]), rng.standard_normal(2))
    srv.forget(0)
    srv.refit()
    srv.observe([7], [0.7])


def test_recover_matches_live_state(empty, tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    cdir = str(tmp_path / "ckpt")
    with ResilientServer(empty, journal=jpath, checkpoint_dir=cdir,
                         checkpoint_every=2) as srv:
        _ops(srv, np.random.default_rng(0))
        q = np.arange(12, dtype=np.int32)
        m_live, v_live = srv.query(q)
    st, n_replayed = recover(empty, jpath, cdir)
    assert 0 < n_replayed < len(read_journal(jpath))   # tail, not the log
    m_rec, v_rec = serving.posterior_moments(st, q)
    close(m_rec, m_live, 1e-5)
    close(v_rec, v_live, 1e-5)
    st_full, n_full = recover(empty, jpath, None)
    assert n_full == len(read_journal(jpath))
    m_f, _ = serving.posterior_moments(st_full, q)
    close(m_f, m_live, 1e-5)


def test_replay_respects_overflow_policy(empty, tmp_path):
    """A journal recorded under eviction degrades identically on replay."""
    jpath = str(tmp_path / "j.jsonl")
    with ResilientServer(empty, journal=jpath, on_overflow="forget_oldest") as srv:
        srv.observe(np.arange(CAPACITY, dtype=np.int32), np.zeros(CAPACITY, np.float32))
        srv.observe([50, 51], [1.0, 2.0])         # evicts 0 and 1
        live_nodes = srv.state.nodes[: int(srv.state.count)].tolist()
    st, _ = recover(empty, jpath)
    assert st.nodes[: int(st.count)].tolist() == live_nodes
    assert 0 not in live_nodes and 50 in live_nodes


def test_replay_runs_fault_free_and_covers_every_event(empty, tmp_path):
    """Replay pins the plan off, so a journal recorded under faults folds
    to what was acked; refit and refit_alpha records replay too."""
    jpath = str(tmp_path / "j.jsonl")
    with Journal(jpath) as j:
        j.log("observe", nodes=[3, 4, 5], ys=[0.1, 0.2, 0.3])
        j.log("refit", f=(empty.f * 1.1).tolist(), sigma_n2=0.06)
        j.log("refit_alpha", f=(empty.f * 1.2).tolist())
    with faults.use_faults("nan_payload:1.0,cg_stall:1"):
        st, n = recover(empty, jpath)
    assert n == 3 and int(st.count) == 3 and int(st.rejected) == 0
    ref = serving.refit(serving.observe_batch(empty, [3, 4, 5], [0.1, 0.2, 0.3]),
                        f=empty.f * 1.1, sigma_n2=0.06)
    ref = serving.refit_alpha(ref, f=empty.f * 1.2, escalate=True)
    close(st.alpha, ref.alpha, 1e-5)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro import serving as jserving
    from repro.core import modulation as jmod
    from repro.core import walks as jwalks
    from repro.graphs import generators as jgen
    from repro.resilience import faults as jfaults
    from repro.resilience import journal as jjournal
    from repro.resilience.server import ResilientServer as JServer
    from repro_torch import interop

    class JX:
        pass

    j = JX()
    j.serving, j.faults, j.journal, j.Server = jserving, jfaults, jjournal, JServer
    g = jgen.grid2d(10, 10)
    m = jmod.diffusion(l_max=4)
    f = np.asarray(m(m.init(jax.random.PRNGKey(1))))
    key = jax.random.PRNGKey(0)
    j.empty = jserving.init_state(g, key, jnp.asarray(f), S2, capacity=CAPACITY,
                                  cfg=jwalks.WalkConfig(n_walkers=6, p_halt=0.25, l_max=4))
    tg = interop.graph_from_numpy(g.neighbors, g.weights, g.deg, device=CPU)
    j.tempty = serving.init_state(tg, int(jwalks.walk_seed(key)),
                                  torch.from_numpy(f.copy()), S2, CAPACITY, CFG)
    return j


PLAN = "nan_payload:0.2,inf_payload:0.1,chol_fail:0.2,seed:3"


def _chaos_ops(srv, rng):
    for _ in range(3):
        srv.observe(rng.choice(100, 5, replace=False), rng.standard_normal(5))
    srv.forget(1)
    srv.observe(rng.choice(100, 5, replace=False), rng.standard_normal(5))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_and_checkpoint_of_either_package_recover_in_the_other(
        jx, tmp_path, writer):
    """An op stream with evictions, journalled and checkpointed by one
    package, recovers in the other: the same live nodes, moments within
    1e-4 of the writer's live state.  (No payload plan here: replay pins
    faults off, so rows rejected live would be accepted on replay, in both
    packages.)"""
    jpath, cdir = str(tmp_path / "j.jsonl"), str(tmp_path / "ckpt")
    q = np.arange(100, dtype=np.int32)
    rng = np.random.default_rng(5)
    kw = dict(journal=jpath, checkpoint_dir=cdir, checkpoint_every=2,
              on_overflow="forget_oldest")
    if writer == "jax":
        with jx.Server(jx.empty, **kw) as srv:
            _chaos_ops(srv, rng)
            live = srv.state
        m_live, v_live = jx.serving.posterior_moments(live, q)
        st, n = recover(jx.tempty, jpath, cdir)
        m, v = serving.posterior_moments(st, torch.from_numpy(q))
    else:
        with ResilientServer(jx.tempty, **kw) as srv:
            _chaos_ops(srv, rng)
            live = srv.state
        m_live, v_live = serving.posterior_moments(live, torch.from_numpy(q))
        st, n = jx.journal.recover(jx.empty, jpath, cdir)
        m, v = jx.serving.posterior_moments(st, q)
    assert 0 < n < 5 and int(live.count) == CAPACITY
    assert int(st.count) == int(live.count)
    np.testing.assert_array_equal(np.asarray(st.nodes), np.asarray(live.nodes))
    close(m, m_live, 1e-4)
    close(v, v_live, 1e-4)


_CHILD = textwrap.dedent("""
    import sys
    sys.path.insert(0, {src!r})
    sys.path.insert(0, {tests!r})
    import numpy as np
    from test_torch_resilience import chaos_stream, empty_state
    from repro_torch.resilience import ResilientServer

    srv = ResilientServer(empty_state({device!r}, capacity=32),
                          journal={jpath!r}, checkpoint_dir={cdir!r},
                          checkpoint_every=3)
    chaos_stream(srv)
    raise SystemExit("kill_at never fired")
""")


def chaos_stream(srv):
    rng = np.random.default_rng(0)
    for _ in range(10):
        srv.observe(rng.integers(0, 100, 2), rng.standard_normal(2))


def kill_and_recover(tmp_path, device):
    """Kill a journalled server in a child process at its 6th op (kill_at:6,
    between the checkpoints after ops 3 and 6), then recover in this one.
    Returns (recovered state, full-journal fold, uninterrupted state)."""
    jpath, cdir = str(tmp_path / "j.jsonl"), str(tmp_path / "ckpt")
    child = _CHILD.format(src=str(ROOT / "src"), tests=str(ROOT / "tests"),
                          device=str(device), jpath=jpath, cdir=cdir)
    env = dict(os.environ, REPRO_FAULTS="kill_at:6")
    proc = subprocess.run([sys.executable, "-c", child], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == KILL_EXIT_CODE, proc.stderr
    assert "kill_at=6 hit at 'serving.observe'" in proc.stderr
    events = read_journal(jpath)
    assert len(events) == 6                      # WAL ahead of the kill
    empty = empty_state(device, capacity=32)
    st, n_tail = recover(empty, jpath, cdir)
    st_full, n_full = recover(empty, jpath, None)
    assert n_full == 6 and 0 < n_tail < 6        # checkpoint skipped a prefix
    # The uninterrupted run: the same stream, no journal, stopped after the
    # killed (journalled, never acked) op.
    ref = ResilientServer(empty)
    rng = np.random.default_rng(0)
    for _ in range(6):
        ref.observe(rng.integers(0, 100, 2), rng.standard_normal(2))
    return st, st_full, ref.state, jpath, cdir, empty


def test_kill_and_recover_chaos(tmp_path):
    st, st_full, uninterrupted, jpath, cdir, empty = kill_and_recover(tmp_path, CPU)
    q = torch.arange(20, dtype=torch.int32)
    for other in (st_full, uninterrupted):
        m1, v1 = serving.posterior_moments(st, q)
        m2, v2 = serving.posterior_moments(other, q)
        close(m1, m2, 1e-5)
        close(v1, v2, 1e-5)
    srv, _ = ResilientServer.recover(empty, jpath, cdir)
    srv.observe([42], [0.42])
    assert int(srv.state.count) == int(st.count) + 1
    assert read_journal(jpath)[-1]["seq"] == 6
    srv.close()


_FLEET_CHILD = textwrap.dedent("""
    import sys
    sys.path.insert(0, {src!r})
    sys.path.insert(0, {tests!r})
    import numpy as np
    from repro_torch import serving
    from repro_torch.resilience import Journal
    from test_torch_resilience import empty_state

    fleet = serving.GPFleetLoop(                  # donate=True is the default
        empty_state({device!r}, capacity=32), batch=8, journal=Journal({jpath!r}))
    rng = np.random.default_rng(0)
    for i in range(6):
        fleet.submit_observe(rng.integers(0, 100, 2), rng.standard_normal(2))
        if i == 2:
            fleet.submit_forget(0)
        fleet.submit(serving.GPRequest(nodes=rng.integers(0, 100, 4).astype(np.int32)))
        fleet.drain()
    raise SystemExit("kill_at never fired")
""")


def fleet_kill_and_recover(tmp_path, device):
    """Kill a journalled, donating GPFleetLoop in a child process at its
    5th kill point (kill_at:5: the 4th iteration's observe, after its
    write-ahead record and before its dispatch), then recover here.
    Returns (recovered state, the eager fold of the journalled ops)."""
    jpath = str(tmp_path / "fleet_j.jsonl")
    child = _FLEET_CHILD.format(src=str(ROOT / "src"), tests=str(ROOT / "tests"),
                                device=str(device), jpath=jpath)
    env = dict(os.environ, REPRO_FAULTS="kill_at:5")
    proc = subprocess.run([sys.executable, "-c", child], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == KILL_EXIT_CODE, proc.stderr
    assert "hit at 'serving.fleet.observe'" in proc.stderr
    # WAL ahead of dispatch: the killed observe is journalled, undispatched.
    events = read_journal(jpath)
    assert [e["type"] for e in events] == ["observe"] * 3 + ["forget", "observe"]
    assert all(e["on_overflow"] == "reject" and e["auto_refit"]
               for e in events if e["type"] == "observe")
    empty = empty_state(device, capacity=32)
    st, n = recover(empty, jpath, None)
    assert n == len(events)
    assert int(st.count) == 4 * 2 - 1            # 4 observes of 2, one forget
    ref = empty
    for ev in events:
        if ev["type"] == "observe":
            ref = serving.observe_batch(ref, ev["nodes"], ev["ys"])
        else:
            ref = serving.forget(ref, ev["slot"])
    return st, ref


def test_fleet_kill_and_recover_chaos(tmp_path):
    """Chaos through the async fleet (the twin of the JAX test of this
    name): the journal holds the killed op, and recovery equals the eager
    fold of the journalled ops bit for bit."""
    st, ref = fleet_kill_and_recover(tmp_path, CPU)
    q = torch.arange(20, dtype=torch.int32)
    for a, b in zip(serving.posterior_moments(st, q), serving.posterior_moments(ref, q)):
        assert torch.equal(a, b)


def test_bo_resume_through_the_checkpoint_manager(tmp_path):
    """The incremental BO loop checkpointed every round through
    CheckpointManager, as the driver twin does, and resumed mid-cycle
    from the saved tree: the same picks and regret as the uninterrupted
    run."""
    g = generators.barabasi_albert(300, m=3, seed=0, device=CPU)
    deg = g.deg.numpy().astype(float)
    truth = (deg - deg.mean()) / (deg.std() + 1e-9)
    obj = lambda idx: truth[np.asarray(idx)]    # noqa: E731  (noise-free)
    cfg = walks.WalkConfig(4, 0.25, 3)
    mod = modulation.diffusion(3)
    kw = dict(n_init=10, n_steps=6, refit_every=3, refit_steps=3,
              noise_std=0.05, f_max=float(truth.max()), n_candidates=48)
    mgr = CheckpointManager(str(tmp_path), keep=2)

    def cb(st):
        if st.iteration <= 4:   # the run "dies" after round 4 (mid-cycle)
            mgr.save(st.iteration, {"x_buf": st.x_buf, "y_buf": st.y_buf,
                                    "params": st.params}, blocking=False,
                     extra={"count": st.count, "iteration": st.iteration,
                            "regret": st.regret})

    full = thompson.thompson_sampling_incremental(g, cfg, mod, obj, 5,
                                                  checkpoint_cb=cb, **kw)
    mgr.wait()
    assert mgr.steps() == [3, 4]
    cap = kw["n_init"] + kw["n_steps"]
    tree, manifest = mgr.restore({
        "x_buf": np.zeros(cap, np.int32), "y_buf": np.zeros(cap, np.float32),
        "params": thompson.mll.init_hyperparams(mod, device=CPU)})
    extra = manifest["extra"]
    state = thompson.BOState(x_buf=tree["x_buf"], y_buf=tree["y_buf"],
                             count=extra["count"], params=tree["params"],
                             regret=list(extra["regret"]),
                             iteration=extra["iteration"])
    assert state.iteration == 4
    resumed = thompson.thompson_sampling_incremental(g, cfg, mod, obj, 5,
                                                     state=state, **kw)
    np.testing.assert_array_equal(full.x_buf, resumed.x_buf)
    assert full.regret == resumed.regret


def test_bo_driver_resumes_from_its_checkpoint(tmp_path, capsys):
    from repro_torch.examples import bo_social_network

    argv = ["--nodes", "400", "--init", "12", "--walkers", "4",
            "--candidates", "32", "--ckpt", str(tmp_path), "--device", "cpu"]
    bo_social_network.main(argv + ["--steps", "2"])
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
    assert "resuming" not in capsys.readouterr().out
    bo_social_network.main(argv + ["--steps", "2"])   # resumes at the end
    out = capsys.readouterr().out
    assert "resuming BO from checkpoint" in out and "final simple regret" in out


def test_serve_gp_chaos_mode(monkeypatch, capsys):
    """The serving twin under REPRO_FAULTS passes its own gates: a finite
    Cholesky, the escalated refit_alpha converged, every query finite."""
    from repro_torch.examples import serve_gp

    monkeypatch.setenv("REPRO_FAULTS", "nan_payload:0.01,cg_stall:1")
    serve_gp.main(["--nodes", "3000", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "chaos mode: injected fault plan [nan_payload:0.01,cg_stall:1]" in out
    assert "queries/s" in out


@pytest.fixture()
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_gpu_resilient_server_matches_the_cpu(cuda, tmp_path):
    """The same chaos op stream through a ResilientServer on the card and on
    the CPU: the same rejections and live nodes, moments within 1e-4; and a
    kill-and-recover on the card within 1e-5 of the uninterrupted run."""
    q = np.arange(100, dtype=np.int32)
    out = {}
    for dev in ("cpu", cuda):
        with faults.use_faults(PLAN), ResilientServer(
                empty_state(dev), on_overflow="forget_oldest") as srv:
            _chaos_ops(srv, np.random.default_rng(5))
        out[str(dev)] = (srv.state, serving.posterior_moments(srv.state, q))
    (a, (am, av)), (b, (bm, bv)) = out["cpu"], out[str(cuda)]
    assert int(a.rejected) == int(b.rejected) > 0
    assert a.nodes.tolist() == b.nodes.cpu().tolist()
    close(bm, am, 1e-4)
    close(bv, av, 1e-4)
    st, _, ref, *_ = kill_and_recover(tmp_path, cuda)
    for x, y in zip(serving.posterior_moments(st, q), serving.posterior_moments(ref, q)):
        close(x, y, 1e-5)


@pytest.mark.gpu
def test_gpu_fleet_kill_and_recover(cuda, tmp_path):
    """The fleet's kill-and-recover on the card (the child never forks the
    CUDA parent): recovery equals the journalled fold bit for bit."""
    st, ref = fleet_kill_and_recover(tmp_path, cuda)
    q = torch.arange(100, dtype=torch.int32, device=cuda)
    for a, b in zip(serving.posterior_moments(st, q), serving.posterior_moments(ref, q)):
        assert torch.equal(a, b)
