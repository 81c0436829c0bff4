"""PyTorch port, the coalesced K̂ payload: each training row's slots that
share a column merged into one entry (``features.coalesce``), kept on the
walk trace (``WalkTrace.coalesced``) and read by the fused K̂ products of a
solve (``KhatOperator``) on the card.

On the CPU: the plain build against the dense Φ, the products through the
coalesced payload against the slot payload's plain version, the trace's
cache of it, and the rule that decides where it is read — tried on the CPU
by making the operator's device test answer "on the card", so that the
whole path runs on the plain versions.  Marked ``gpu``: the one-payload
aggregate kernel bit for bit against its plain version, the build, and the
products and a posterior request on the card.

Tolerances: a product through the coalesced payload sums the same float32
products in another order (a row's slots on a column first): 1e-5 of the
result's scale, as the fused kernel's index tests; through CG 1e-4.
"""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import features, linops, modulation, walks  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.ell_spmv import ref  # noqa: E402
from repro_torch.kernels.gram_block import ops as gram_ops  # noqa: E402
from repro_torch.kernels.gram_block import ref as gram_ref  # noqa: E402

TOL = 1e-5
CG_TOL = 1e-4


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1e-30)
    assert float(np.max(np.abs(got - want))) <= tol * scale


@pytest.fixture(autouse=True)
def clean_obs(monkeypatch):
    monkeypatch.delenv("REPRO_OBS", raising=False)
    obs.reset_enabled()
    obs.REGISTRY.reset()
    yield
    obs.reset_enabled()
    obs.REGISTRY.reset()


@pytest.fixture
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def as_on_card(monkeypatch):
    """The operator's device test answers "on the card" for CPU tensors, so
    the coalesced path runs on the plain versions."""
    monkeypatch.setattr(linops, "_on_card", lambda t: True)


# (graph, nodes, walkers, p_halt, l_max, training rows every `step` nodes):
# the ring at the serving width (K = 144), and a k-NN sphere at the wind
# example's (K = 900), whose walks jump and repeat their columns.
PROBLEMS = {
    "ring": (lambda dev: generators.ring(3000, k=3, device=dev), 16, 0.1, 8, 7),
    "sphere": (lambda dev: generators.knn_sphere(2000, k=6, seed=0,
                                                 device=dev)[0],
               100, 0.1, 8, 25),
}


def _problem(name, dev="cpu", seed=11):
    make, walkers, p_halt, l_max, step = PROBLEMS[name]
    g = make(dev)
    tr = walks.sample_walks(g, seed, walkers, p_halt, l_max)
    rows = torch.arange(0, g.n_nodes, step, device=g.neighbors.device)
    mod = modulation.diffusion(l_max)
    f = mod(mod.init(device=dev)).detach()
    return g, tr, features.take_rows(tr, rows), f


def _coalesced_dense(c, n):
    m = c.vals.shape[0]
    out = torch.zeros((m, n), dtype=torch.float64, device=c.vals.device)
    rows = torch.arange(m, device=c.vals.device)[:, None].expand_as(c.cols)
    out.index_put_((rows.reshape(-1), c.cols.reshape(-1).long()),
                   c.vals.reshape(-1).double(), accumulate=True)
    return out


def _counter(name):
    return obs.REGISTRY.snapshot()["counters"].get(name, 0)


# --------------------------------------------------------------------------
# The plain build and the products.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_plain_build_is_the_dense_phi_with_duplicates_summed(name):
    """One entry per distinct live (row, column), in order of first
    occurrence, its value the sum of the row's slots there; the payload cut
    to the largest count rounded up to 32, padding node 0 at value 0."""
    g, _, tx, f = _problem(name)
    n = g.n_nodes
    c = features.coalesce(tx, f, n)
    vals = features.feature_values(tx, f)
    close(_coalesced_dense(c, n).numpy(),
          features.materialize_phi(tx, f, n).double().numpy())
    counts = (c.vals != 0).sum(dim=1)
    distinct = features.nnz_per_row(tx)
    assert torch.equal(counts.int(), distinct)
    assert c.vals.shape[1] == min(tx.slots, -(-int(distinct.max()) // 32) * 32)
    assert c.vals.shape[1] < tx.slots
    pos = torch.arange(c.vals.shape[1])[None, :]
    pad = pos >= counts[:, None]
    assert bool((c.vals[pad] == 0).all()) and bool((c.cols[pad] == 0).all())
    assert bool((c.cols >= 0).all()) and bool((c.cols < n).all())
    for i in range(0, vals.shape[0], 17):
        live = vals[i] != 0
        firsts = list(dict.fromkeys(tx.cols[i][live].tolist()))
        assert c.cols[i, :len(firsts)].tolist() == firsts
    want = kindex_of(c.cols, c.vals, n)
    assert torch.equal(c.index.uniq, want.uniq)
    assert torch.equal(c.index.order, want.order)
    # Kept ÷ live: how far coalescing cuts the slots a product reads.
    assert int(counts.sum()) < 0.5 * int((vals != 0).sum())


def kindex_of(cols, vals, n):
    from repro_torch.kernels.ell_spmv import index

    return index.column_index(cols, vals, n)


@pytest.mark.parametrize("r", [1, 16, 64])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_products_through_the_coalesced_payload(name, r):
    """K̂_xx (coalesced on both sides) and the cross K̂_{·x} (coalesced
    column side, the full trace's slots as rows), by the fused kernel's
    algorithm and by the dispatched product, against the slot payload's
    unfused plain version."""
    g, tr, tx, f = _problem(name)
    n = g.n_nodes
    c = features.coalesce(tx, f, n)
    vx = features.feature_values(tx, f)
    vt = features.feature_values(tr, f)
    gen = torch.Generator().manual_seed(r)
    shape = (tx.n_nodes,) if r == 1 else (tx.n_nodes, r)
    v = torch.randn(shape, generator=gen)
    if r == 1:
        v = v.reshape(-1)
    want_xx = ref.khat_matvec_ref(vx, tx.cols, vx, tx.cols, v, n)
    close(ref.khat_matvec_indexed_ref(c.vals, c.cols, c.vals, c.index, v),
          want_xx.numpy())
    close(dispatch.khat_matvec(c.vals, c.cols, c.vals, c.cols, v, n, c.index),
          want_xx.numpy())
    want_cross = ref.khat_matvec_ref(vt, tr.cols, vx, tx.cols, v, n)
    close(ref.khat_matvec_indexed_ref(vt, tr.cols, c.vals, c.index, v),
          want_cross.numpy())


# --------------------------------------------------------------------------
# The trace's cache.
# --------------------------------------------------------------------------


def test_cache_builds_once_per_trace_and_f(monkeypatch):
    """Built once per (trace, f, node count); rebuilt after an in-place
    write to cols, loads, lens or f, and for another f — also one that
    lies at the freed f's address, with its version and dtype."""
    builds = []
    real = features.coalesce

    def counted(*a, **k):
        builds.append(1)
        return real(*a, **k)

    monkeypatch.setattr(features, "coalesce", counted)
    g, _, tx, f = _problem("ring")
    n = g.n_nodes
    c = features.coalesced(tx, f, n)
    assert features.coalesced(tx, f, n) is c and len(builds) == 1
    assert features.coalesced(tx, f, n + 1) is not c and len(builds) == 2
    c = features.coalesced(tx, f, n)
    assert len(builds) == 3
    for t in (tx.cols, tx.loads, tx.lens):
        t[0, 0] = t[0, 0]
        assert features.coalesced(tx, f, n) is not c
        c = features.coalesced(tx, f, n)
    assert len(builds) == 6
    f2 = f.clone()
    assert features.coalesced(tx, f2, n) is not c and len(builds) == 7
    c = features.coalesced(tx, f2, n)
    f2.mul_(1.0)
    assert features.coalesced(tx, f2, n) is not c and len(builds) == 8
    # A freed f, and a new tensor at its address with its version and
    # dtype: two views of one buffer share storage and version counter.
    buf = f.repeat(2)
    f3 = buf[:f.shape[0]]
    c = features.coalesced(tx, f3, n)
    ptr, version = f3.data_ptr(), f3._version
    del f3
    gc.collect()
    f4 = buf[:f.shape[0]]
    assert (f4.data_ptr(), f4._version, f4.dtype) == (ptr, version, f.dtype)
    assert features.coalesced(tx, f4, n) is not c and len(builds) == 10


# --------------------------------------------------------------------------
# Where the coalesced payload is read.
# --------------------------------------------------------------------------


def _khat_today(tx, f, n, v):
    vx = features.feature_values(tx, f)
    return dispatch.khat_matvec(vx, tx.cols, vx, tx.cols, v, n,
                                tx.column_index(n))


def test_engages_on_the_card_for_a_float32_f_without_gradient(as_on_card):
    """With every condition met, the square product reads the coalesced
    payload on both sides and the cross on its column side, each counted."""
    obs.enable()
    g, tr, tx, f = _problem("sphere")
    n = g.n_nodes
    v = torch.randn((tx.n_nodes, 4), generator=torch.Generator().manual_seed(3))
    got = linops.khat(tx, f, n).matvec(v)
    assert "_coalesced" in tx.__dict__ and "_column_index" not in tx.__dict__
    vx = features.feature_values(tx, f)
    close(got, ref.khat_matvec_ref(vx, tx.cols, vx, tx.cols, v, n).numpy())
    vt = features.feature_values(tr, f)
    cross = linops.khat_cross(tr, tx, f, n).matvec(v)
    close(cross, ref.khat_matvec_ref(vt, tr.cols, vx, tx.cols, v, n).numpy())
    assert _counter("khat.coalesced_products") == 2
    assert _counter("khat.coalesce.count") == 1


@pytest.mark.parametrize("why", ["cpu", "requires_grad", "bfloat16", "reduce"])
def test_other_calls_take_todays_path(monkeypatch, why):
    """Off the card, with an f that needs a gradient, a bf16 payload or a
    reduce hook, the product is today's, bit for bit, and nothing is
    coalesced or counted."""
    obs.enable()
    g, _, tx, f = _problem("ring")
    n = g.n_nodes
    v = torch.randn((tx.n_nodes, 3), generator=torch.Generator().manual_seed(4))
    if why != "cpu":
        monkeypatch.setattr(linops, "_on_card", lambda t: True)
    op = linops.khat(tx, f, n)
    want = _khat_today(tx, f, n, v)
    if why == "requires_grad":
        fg = f.clone().requires_grad_(True)
        op = linops.khat(tx, fg, n)
        got = op.matvec(v)
        got.sum().backward()
        assert fg.grad is not None
        got = got.detach()
    elif why == "bfloat16":
        op = op.with_matvec_dtype("bfloat16")
        got = op.matvec(v)
        fb = f.to(torch.bfloat16)
        vb = features.feature_values(tx, fb)
        want = dispatch.khat_matvec(vb, tx.cols, vb, tx.cols, v, n,
                                    tx.column_index(n))
    elif why == "reduce":
        got = linops.khat(tx, f, n, reduce=lambda u: u).matvec(v)
        vx = features.feature_values(tx, f)
        want = dispatch.phi_matvec(
            vx, tx.cols, dispatch.phi_t_matvec(vx, tx.cols, v, n))
    else:
        got = op.matvec(v)
    assert torch.equal(got, want)
    assert "_coalesced" not in tx.__dict__
    assert _counter("khat.coalesced_products") == 0


@pytest.mark.parametrize("warm", [False, True])
def test_fit_keeps_the_slot_path(as_on_card, monkeypatch, warm):
    """The LML fit's steps, its CG solve at a stopped gradient included,
    read the slot payload on the card as on the CPU: nothing is coalesced or
    counted, and the fitted parameters and history are the CPU path's bit
    for bit."""
    from repro_torch import solvers
    from repro_torch.gp import mll

    g, _, tx, _ = _problem("ring")
    n = g.n_nodes
    mod = modulation.diffusion(8)
    y = torch.randn((tx.n_nodes,), generator=torch.Generator().manual_seed(8))
    strategy = solvers.MLL_DEFAULT.with_(warm_start=warm)

    def fit(trace):
        return mll.fit_hyperparams(trace, mod, y, n,
                                   torch.Generator().manual_seed(9), steps=3,
                                   chunk=3, n_probes=4, strategy=strategy)

    obs.enable()
    got = fit(tx)
    assert "_coalesced" not in tx.__dict__
    assert _counter("khat.coalesced_products") == 0
    assert _counter("khat.coalesce.count") == 0
    monkeypatch.setattr(linops, "_on_card", lambda t: False)
    want = fit(features.take_rows(tx, torch.arange(tx.n_nodes)))
    assert got.history == want.history
    for a, b in ((got.params["mod"]["log_beta"], want.params["mod"]["log_beta"]),
                 (got.params["mod"]["log_sigma_f"],
                  want.params["mod"]["log_sigma_f"]),
                 (got.params["log_sigma_n"], want.params["log_sigma_n"])):
        assert torch.equal(a, b)


def test_posterior_request_builds_once_and_reads_it_everywhere(as_on_card,
                                                               monkeypatch):
    """A pathwise request: one ``walks.column_index`` build (the coalesced
    payload), no slot-level index of Φ_x, every K̂ product coalesced (CG's
    iterations and the cross), and the samples of today's path within CG's
    tolerance.  The tap reads what was built."""
    from repro_torch.gp import posterior

    g, tr, _, f = _problem("sphere")
    n = g.n_nodes
    rows = torch.arange(0, n, 25)
    y = torch.randn((rows.shape[0],), generator=torch.Generator().manual_seed(5))

    def request():
        gen = torch.Generator().manual_seed(6)
        return posterior.pathwise_samples(tr, rows, f, 0.05, y, gen,
                                          n_samples=4, return_diagnostics=True)

    slot_builds = []
    real_index = walks.WalkTrace.column_index

    def counted_index(self, n_nodes):
        if self is not tr:
            slot_builds.append(1)
        return real_index(self, n_nodes)

    monkeypatch.setattr(walks.WalkTrace, "column_index", counted_index)
    sink = obs.RingBufferSink(100_000)
    obs.REGISTRY.add_sink(sink)
    obs.enable()
    try:
        got, iters, _ = request()
    finally:
        obs.REGISTRY.remove_sink(sink)
    builds = [e for e in sink.events
              if e["type"] == "span" and e["name"] == "walks.column_index"]
    taps = [e for e in sink.events
            if e["type"] == "tap" and e["name"] == "khat.coalesce"]
    assert len(builds) == 1 and len(taps) == 1 and not slot_builds
    assert _counter("khat.coalesced_products") == iters + 1
    tx = features.take_rows(tr, rows)
    c = features.coalesce(tx, f, n)
    vx = features.feature_values(tx, f)
    assert taps[0]["values"] == {"rows": rows.shape[0],
                                 "live": int((vx != 0).sum()),
                                 "kept": int((c.vals != 0).sum()),
                                 "kc": c.vals.shape[1]}
    monkeypatch.setattr(linops, "_on_card", lambda t: False)
    want, iters_today, _ = request()
    assert abs(iters - iters_today) <= 1
    close(got, want.numpy(), CG_TOL)


# --------------------------------------------------------------------------
# On the card.
# --------------------------------------------------------------------------


def _walk_like(rng, m, k, n, walkers, repeats_start=True, zero_frac=0.3):
    """A payload shaped as walk deposits: each walker's step-0 slot is the
    row's own node (so it repeats ``walkers`` times), later steps wander."""
    cols = rng.integers(0, n, (m, k)).astype(np.int32)
    if repeats_start and walkers:
        cols[:, ::k // walkers] = (np.arange(m) % n)[:, None]
    near = rng.random((m, k)) < 0.5
    cols[near] = (np.arange(m)[:, None].repeat(k, 1)[near]
                  + rng.integers(0, 4, near.sum())) % n
    vals = rng.standard_normal((m, k)).astype(np.float32)
    vals[rng.random((m, k)) < zero_frac] = 0.0
    return vals, cols


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,walkers", [(1024, 144, 16), (700, 900, 100),
                                         (300, 33, 3), (50, 70, 7), (0, 144, 16),
                                         (40, 1, 1)])
def test_gpu_aggregate_one_payload_bit_equal_to_plain(cuda, m, k, walkers):
    """gram_aggregate on one payload, launched alone, against
    ``aggregate_rows_ref``: columns, counts and values bit for bit, the
    entries past each row's count included (at K = 900 the step-0 column
    repeats 100 times a row)."""
    rng = np.random.default_rng(m + k)
    vals, cols = _walk_like(rng, m, k, 5000, walkers)
    tv, tc = torch.from_numpy(vals).to(cuda), torch.from_numpy(cols).to(cuda)
    before = gram_ops.LAUNCHES["gram_aggregate"]
    got = gram_ops.aggregate_rows_raw(tv, tc)
    want = gram_ref.aggregate_rows_ref(tv, tc)
    assert gram_ops.LAUNCHES["gram_aggregate"] == before + (1 if m else 0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    again = dispatch.aggregate_rows(tv, tc)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_gpu_build_is_bit_equal_and_pads_with_valid_ids(cuda):
    """Two builds give bit-equal payloads and indices; rows whose kernel
    padding stops at 32 entries, in a payload cut to 128 by one row of 100
    distinct columns, read node 0 at value 0 past their counts."""
    rng = np.random.default_rng(3)
    m, k, n = 2000, 900, 100_000
    vals, cols = _walk_like(rng, m, k, n, 100)
    cols[1:] = cols[1:] % 40 + 1000        # ≤ 40 distinct columns a row
    cols[0, :100] = np.arange(100)          # one row of 100 distinct
    vals[0] = 0.0
    vals[0, :100] = 1.0
    tr = walks.WalkTrace(cols=torch.from_numpy(cols).to(cuda),
                         loads=torch.from_numpy(np.abs(vals)).to(cuda),
                         lens=torch.zeros((m, k), dtype=torch.int32, device=cuda))
    f = torch.ones((1,), device=cuda)
    a = features.coalesce(tr, f, n)
    b = features.coalesce(tr, f, n)
    assert a.vals.shape == (m, 128)
    for x, y in ((a.vals, b.vals), (a.cols, b.cols), (a.index.uniq, b.index.uniq),
                 (a.index.order, b.index.order), (a.index.seg, b.index.seg),
                 (a.index.node_map, b.index.node_map)):
        assert torch.equal(x, y)
    counts = (a.vals != 0).sum(dim=1)
    pad = torch.arange(128, device=cuda)[None, :] >= counts[:, None]
    assert bool((a.cols[pad] == 0).all()) and bool((a.vals[pad] == 0).all())
    close(_coalesced_dense(a, n).cpu().numpy(),
          features.materialize_phi(tr, f, n).double().cpu().numpy())


def _card_problem(cuda, name):
    g, tr, tx, f = _problem(name, dev=cuda)
    return g.n_nodes, tr, tx, f


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [("ring", 1024, 256), ("sphere", 4096, 64)])
def test_gpu_coalesced_products_match_slot_payload(cuda, shape):
    """K̂_xx and the cross through the operator on the card (coalesced,
    counted) against the slot payload's plain version, at [1024, 144] with
    R = 256 and a [4096, 900] sphere block with R = 64."""
    name, t, r = shape
    make, walkers, p_halt, l_max, _ = PROBLEMS[name]
    g = (generators.ring(10**5, k=3, device=cuda) if name == "ring"
         else generators.knn_sphere(20_000, k=6, seed=0, device=cuda)[0])
    n = g.n_nodes
    tr = walks.sample_walks(g, 21, walkers, p_halt, l_max)
    rows = torch.from_numpy(np.random.default_rng(t).choice(n, t, replace=False)
                            ).to(cuda)
    tx = features.take_rows(tr, rows)
    mod = modulation.diffusion(l_max)
    f = mod(mod.init(device=cuda)).detach()
    v = torch.randn((t, r), device=cuda, generator=torch.Generator(cuda).manual_seed(7))
    obs.enable()
    kxx = linops.khat(tx, f, n).matvec(v)
    cross = linops.khat_cross(tr, tx, f, n).matvec(v)
    assert _counter("khat.coalesced_products") == 2
    assert "_column_index" not in tx.__dict__
    assert torch.equal(kxx, linops.khat(tx, f, n).matvec(v))
    vx = features.feature_values(tx, f)
    vt = features.feature_values(tr, f)
    close(kxx.cpu(), ref.khat_matvec_ref(vx, tx.cols, vx, tx.cols, v, n).cpu().numpy())
    close(cross.cpu(),
          ref.khat_matvec_ref(vt, tr.cols, vx, tx.cols, v, n).cpu().numpy())


@pytest.mark.gpu
def test_gpu_posterior_request_builds_once_and_counts(cuda, monkeypatch):
    """A pathwise request on the card: one ``walks.column_index`` build,
    no slot-level index of Φ_x, every K̂ product coalesced (CG's iterations
    and the cross), one aggregate launch, and the tap's numbers those of
    the payload."""
    from repro_torch.gp import posterior

    g = generators.knn_sphere(20_000, k=6, seed=0, device=cuda)[0]
    n = g.n_nodes
    tr = walks.sample_walks(g, 5, 100, 0.1, 8)
    rows = torch.arange(0, n, 7, device=cuda)
    mod = modulation.diffusion(8)
    f = mod(mod.init(device=cuda)).detach()
    y = torch.randn((rows.shape[0],), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(5))
    slot_builds = []
    real_index = walks.WalkTrace.column_index

    def counted_index(self, n_nodes):
        if self is not tr:
            slot_builds.append(1)
        return real_index(self, n_nodes)

    monkeypatch.setattr(walks.WalkTrace, "column_index", counted_index)
    sink = obs.RingBufferSink(100_000)
    obs.REGISTRY.add_sink(sink)
    obs.enable()
    before = dispatch.launch_counts()
    try:
        _, iters, _ = posterior.pathwise_samples(
            tr, rows, f, 0.05, y, torch.Generator(cuda).manual_seed(6),
            n_samples=8, return_diagnostics=True)
    finally:
        obs.REGISTRY.remove_sink(sink)
    after = dispatch.launch_counts()
    builds = [e for e in sink.events
              if e["type"] == "span" and e["name"] == "walks.column_index"]
    taps = [e["values"] for e in sink.events
            if e["type"] == "tap" and e["name"] == "khat.coalesce"]
    assert len(builds) == 1 and len(taps) == 1 and not slot_builds
    assert after["gram_aggregate"] - before["gram_aggregate"] == 1
    assert after["khat_fused"] - before["khat_fused"] == iters + 1
    assert _counter("khat.coalesced_products") == iters + 1
    tx = features.take_rows(tr, rows)
    c = features.coalesce(tx, f, n)
    vx = features.feature_values(tx, f)
    assert taps[0] == {"rows": rows.shape[0], "live": int((vx != 0).sum()),
                       "kept": int((c.vals != 0).sum()), "kc": c.vals.shape[1]}
    assert taps[0]["kept"] < 0.3 * taps[0]["live"]
