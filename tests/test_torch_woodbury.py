"""PyTorch port, the Nyström–Woodbury preconditioner apply: its plain version
and autograd Function against the JAX package's oracle, its Pallas kernel
(interpret mode) and that kernel's custom VJP, and (marked ``gpu``) the CUDA
kernel against the plain version on the card.

Tolerances, relative to the result's scale: one apply is two small products,
a diagonal scale and a subtraction, summed in another order than XLA's (and,
on the card, than PyTorch's): 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.woodbury_apply import ops, ref  # noqa: E402

TOL = 1e-5
# (T, r, R or None for a 1-D v, noise kind): ragged T, r = 1, 1-D v, and the
# three diagonals the preconditioner builds.
CASES = [
    (48, 12, None, "scalar"),
    (48, 12, 3, "vector"),
    (37, 1, None, "masked"),
    (37, 1, 5, "vector"),
    (120, 40, 9, "masked"),
    (1, 3, 2, "scalar"),
    (513, 17, 16, "vector"),
]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def pieces(t, r, cols, noise, seed=0):
    """B, D⁻¹, E⁻¹ = (I + BᵀD⁻¹B)⁻¹ and v as numpy float32.

    ``noise``: one σ² ("scalar"), heteroscedastic with zero-noise rows whose
    D⁻¹ is 1.0 ("vector"), or 1e6 noise (D⁻¹ = 1e-6) on padding ("masked")."""
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((t, r)).astype(np.float32)
    if noise == "scalar":
        dinv = np.full(t, 20.0, np.float32)
    elif noise == "vector":
        dinv = (1.0 / (0.5 + rng.random(t))).astype(np.float32)
        dinv[::4] = 1.0
    else:
        dinv = np.full(t, 20.0, np.float32)
        dinv[rng.random(t) < 0.3] = 1e-6
    e = np.eye(r) + b.T.astype(np.float64) @ (dinv[:, None] * b)
    einv = np.linalg.inv(e).astype(np.float32)
    v = rng.standard_normal((t,) if cols is None else (t, cols)).astype(np.float32)
    return b, dinv, einv, v


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.kernels import woodbury_apply as jwood

    return jax, jnp, jwood


@pytest.fixture
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_oracle_and_interpret_kernel(jx, case):
    jax, jnp, jwood = jx
    arrs = pieces(*case)
    got = ref.woodbury_apply_ref(*map(torch.from_numpy, arrs))
    close(got, jwood.woodbury_apply_ref(*map(jnp.asarray, arrs)))
    close(got, jwood.woodbury_apply(*map(jnp.asarray, arrs), interpret=True))


@pytest.mark.parametrize("case", CASES[:3])
def test_raw_and_dispatch_on_cpu_are_the_plain_version(case):
    arrs = [torch.from_numpy(a) for a in pieces(*case, seed=1)]
    before = dict(ops.LAUNCHES)
    want = ref.woodbury_apply_ref(*arrs)
    assert torch.equal(ops.woodbury_apply_raw(*arrs), want)
    assert torch.equal(dispatch.woodbury_apply(*arrs), want)
    # A CPU tensor never counts as a kernel launch.
    assert ops.LAUNCHES == before
    assert "woodbury_apply" in dispatch.launch_counts()


@pytest.mark.parametrize("case", [(48, 12, None, "vector"), (37, 5, 3, "masked")])
def test_autograd_matches_jax_vjp_of_pallas_kernel(jx, case):
    """The Function's four cotangents against jax.vjp of the Pallas kernel's
    custom VJP (d_v through the kernel with E⁻ᵀ, the rest through the
    oracle), on a non-symmetric E⁻¹ so that E⁻ᵀ ≠ E⁻¹ shows."""
    jax, jnp, jwood = jx
    b, dinv, einv, v = pieces(*case, seed=2)
    einv = einv + 0.1 * np.triu(np.ones_like(einv), 1)
    g = np.random.default_rng(3).standard_normal(v.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jwood.woodbury_pallas(*a, interpret=True),
                       *map(jnp.asarray, (b, dinv, einv, v)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (b, dinv, einv, v)]
    y = ops.woodbury_apply(*leaves)
    close(y, out)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    for gt, wt in zip(got, want):
        close(gt, wt)


def test_autograd_computes_only_the_asked_cotangents():
    b, dinv, einv, v = (torch.from_numpy(a) for a in pieces(40, 6, 2, "vector"))
    g = torch.ones_like(v)
    vv = v.clone().requires_grad_()
    (d_v,) = torch.autograd.grad(ops.woodbury_apply(b, dinv, einv, vv), vv, g)
    close(d_v, ref.woodbury_apply_ref(b, dinv, einv.T.contiguous(), g))
    bb = b.clone().requires_grad_()
    y = ops.woodbury_apply(bb, dinv, einv, v)
    (d_b,) = torch.autograd.grad(y, bb, g)
    b2 = b.clone().requires_grad_()
    (want,) = torch.autograd.grad(ref.woodbury_apply_ref(b2, dinv, einv, v), b2, g)
    close(d_b, want)


def test_dispatch_casts_to_f32_and_stays_differentiable():
    """dispatch.woodbury_apply hands the wrapper float32 contiguous operands
    (as the kernel needs them) and keeps autograd through the cast."""
    b, dinv, einv, v = (torch.from_numpy(a) for a in pieces(40, 6, 3, "masked"))
    b64 = b.double().T.contiguous().T.requires_grad_()   # f64, column-major
    got = dispatch.woodbury_apply(b64, dinv, einv.T.contiguous().T, v)
    assert got.dtype == torch.float32
    close(got, ref.woodbury_apply_ref(b, dinv, einv, v))
    (d_b,) = torch.autograd.grad(got.sum(), b64)
    b2 = b.clone().requires_grad_()
    (want,) = torch.autograd.grad(ref.woodbury_apply_ref(b2, dinv, einv, v).sum(), b2)
    assert d_b.dtype == torch.float64
    close(d_b, want)


def emulate_kernel(b, dinv, einv, v):
    """The kernel's arithmetic in its fixed order, in float32 plain PyTorch
    (separate multiplies and adds where the kernel fuses them), for one
    launch (R ≤ launch_cols(r)), with ops.plan's blocks and tiles.
    Partials: block p takes ``rows`` rows in tiles of ``tile``; in a tile,
    row i goes to group i mod G (G = 512 / ⌈r⌉₃₂), each group's sum runs
    over the tiles in order, and the groups are added in order.  u: the
    partials in ``groups`` runs of consecutive partials, each run summed in
    order from zero, the runs added in order; ``groups`` is 512 over the
    entries of u that a block sums (all of u where every block forms all of
    it, else its ⌈r/16⌉-row slice).  A row of s = E⁻¹u: 4 lane sums over
    quarters of k, each from a lane-dependent offset round its quarter, and
    a butterfly.  A row of out: 4 lane sums over j ≡ q (mod 4) and a
    butterfly."""
    t, r = b.shape
    v2 = v.reshape(t, -1)
    cb = v2.shape[1]
    w = dinv[:, None] * v2
    rows, tile, n_p, *_ = ops.plan(t, r, cb)
    groups = 512 // min(-(-r // 32) * 32, 512)
    parts = []
    for blk in range(n_p):
        i0 = blk * rows
        nr = max(0, min(t, i0 + rows) - i0)
        acc = torch.zeros((groups, r, cb))
        for k0 in range(0, nr, tile):
            for i in range(min(tile, nr - k0)):
                g = i % groups
                acc[g] = acc[g] + b[i0 + k0 + i][:, None] * w[i0 + k0 + i][None, :]
        part = acc[0]
        for g in range(1, groups):
            part = part + acc[g]
        parts.append(part)

    full = r * cb <= 256 and r * r <= 16384
    js, kc = -(-r // 16), -(-r // 4)
    u = torch.zeros((r, cb))
    for j in range(r):
        ent = (r if full else min(js, r - j // js * js)) * cb
        runs = max(1, min(n_p, 512 // ent))
        per = -(-n_p // runs)
        sums = []
        for q in range(runs):
            acc = torch.zeros(cb)
            for p_ in range(q * per, min(n_p, (q + 1) * per)):
                acc = acc + parts[p_][j]
            sums.append(acc)
        u[j] = sums[0]
        for x in sums[1:]:
            u[j] = u[j] + x

    def butterfly(lanes, offs):
        lanes = list(lanes)
        for off in offs:
            lanes = [lanes[i] + lanes[i ^ off] for i in range(len(lanes))]
        return lanes[0]

    s = torch.zeros_like(u)
    for j in range(r):
        quarters = []
        for ch in range(4):
            k0 = min(r, ch * kc)
            n = min(r, k0 + kc) - k0
            kk = (ch * 8 + (j if full else j % js) % 8) % n if n else 0
            acc = torch.zeros(cb)
            for _ in range(n):
                acc = acc + einv[j, k0 + kk] * u[k0 + kk]
                kk = (kk + 1) % n
            quarters.append(acc)
        s[j] = butterfly(quarters, (1, 2))
    out = torch.empty_like(v2)
    for i in range(t):
        lanes = [torch.zeros(cb) for _ in range(4)]
        for j in range(r):
            lanes[j % 4] = lanes[j % 4] + b[i, j] * s[j]
        out[i] = w[i] - dinv[i] * butterfly(lanes, (1, 2))
    return out.reshape(v.shape)


@pytest.mark.parametrize("case", [(48, 12, 3, "vector"), (37, 1, None, "masked"),
                                  (70, 40, 9, "scalar"), (100, 64, 2, "vector")])
def test_kernel_summation_order_matches_jax_interpret(jx, case):
    """The kernel's fixed summation order, emulated, against the Pallas
    kernel in interpret mode, within 1e-5 of scale: each block of u formed
    whole (r·R ≤ 256) and in 16 slices, one and several partials."""
    jax, jnp, jwood = jx
    arrs = pieces(*case, seed=7)
    got = emulate_kernel(*map(torch.from_numpy, arrs))
    close(got, jwood.woodbury_apply(*map(jnp.asarray, arrs), interpret=True))


def test_kernel_summation_order_across_tiles_matches_jax_interpret(jx):
    """As above at T = 2100: 64 partial blocks of 33 rows, each streamed as
    a tile of 32 rows and one of 1, and u summed in runs of partials."""
    jax, jnp, jwood = jx
    arrs = pieces(2100, 20, 4, "masked", seed=11)
    assert ops.plan(2100, 20, 4)[:3] == (33, 32, 64)
    got = emulate_kernel(*map(torch.from_numpy, arrs))
    close(got, jwood.woodbury_apply(*map(jnp.asarray, arrs), interpret=True))


def test_launch_cols_and_plan():
    """Columns per launch, and the plan at the shapes the repo runs."""
    assert [ops.launch_cols(r) for r in (1, 128, 512, 513, 1024, 8192, 8447)] == \
        [16, 16, 16, 15, 8, 1, 1]
    # The solvers' CG shape: 64 blocks of 63 rows, 4 clusters of 63 rows a
    # block, one [128] partial each.
    assert ops.plan(4000, 128, 1) == (63, 32, 64, 4, 63, 64 * 128)
    assert ops.plan(4000, 128, 9) == (63, 32, 64, 4, 63, 64 * 128 * 12)
    assert ops.plan(565, 128, 1) == (32, 32, 18, 1, 36, 18 * 128)
    assert ops.plan(1, 8447, 1)[:4] == (32, 2, 1, 1)


@pytest.mark.parametrize("r", [1, 37, 64, 128, 256, 263, 1024, 8192, 8447])
def test_plan_is_a_pure_function_that_fits(r):
    """For every shape the plan covers all T rows within the card's shared
    memory: at least one row of B a tile, partial blocks of at least
    MAX_TILE rows, at most MAX_PARTIALS of them past MAX_PARTIALS·MAX_TILE
    rows, clusters of 16 blocks over all rows, and one [r, columns] partial
    per block in the scratch.  The combine buffer holds a thread's row or,
    past 512 rows of u a block (r > 8192), a row of u each."""
    for cw in sorted({1, 9, ops.launch_cols(r)}):
        if cw > ops.launch_cols(r):
            continue
        p = ops._cbp(cw)
        for t in (1, 16, 37, 500, 4000, 4992, 5008, 6368, 13000, 100000):
            got = ops.plan(t, r, cw)
            assert got == ops.plan.__wrapped__(t, r, cw)
            rows, tile, parts, clus, rows_f, need = got
            assert 1 <= tile <= ops.MAX_TILE
            assert ops._layout_floats(2 * tile, r, cw) <= ops.SMEM_FLOATS
            assert parts * rows >= t > (parts - 1) * rows
            assert rows >= ops.MAX_TILE and parts <= ops.MAX_PARTIALS
            assert clus * 16 * rows_f >= t and 1 <= clus <= ops.MAX_CLUSTERS
            assert need == parts * r * p
            js = -(-r // 16)
            assert js * cw <= max(js, ops.THREADS) * p


# --------------------------------------------------------------------------
# On the card.
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES + [(4000, 256, 64, "masked"),
                                          (4000, 128, 1, "scalar"),
                                          (333, 64, 100, "vector")])
def test_gpu_woodbury_kernel_matches_plain(cuda, case):
    arrs = [torch.from_numpy(a).to(cuda) for a in pieces(*case, seed=4)]
    before = ops.LAUNCHES["woodbury_apply"]
    got = ops.woodbury_apply_raw(*arrs)
    torch.cuda.synchronize()
    cols = 1 if case[2] is None else case[2]
    assert ops.LAUNCHES["woodbury_apply"] == before + -(-cols // ops.MAX_COLS)
    close(got, ref.woodbury_apply_ref(*arrs))


@pytest.mark.gpu
def test_gpu_woodbury_dv_is_the_kernel_with_einv_transposed(cuda):
    b, dinv, einv, v = (torch.from_numpy(a).to(cuda)
                        for a in pieces(4000, 128, 9, "masked", seed=5))
    einv = einv + 0.1 * torch.triu(torch.ones_like(einv), 1)
    g = torch.randn(v.shape, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    vv = v.clone().requires_grad_()
    before = ops.LAUNCHES["woodbury_apply"]
    (d_v,) = torch.autograd.grad(ops.woodbury_apply(b, dinv, einv, vv), vv, g)
    assert ops.LAUNCHES["woodbury_apply"] == before + 2
    v2 = v.clone().requires_grad_()
    (want,) = torch.autograd.grad(ref.woodbury_apply_ref(b, dinv, einv, v2), v2, g)
    close(d_v, want)


@pytest.mark.gpu
def test_gpu_woodbury_refuses_bad_inputs(cuda):
    b, dinv, einv, v = (torch.from_numpy(a).to(cuda) for a in pieces(40, 6, 2, "scalar"))
    with pytest.raises(TypeError):
        ops.woodbury_apply_raw(b.double(), dinv, einv, v)
    with pytest.raises(ValueError, match="contiguous"):
        ops.woodbury_apply_raw(b, dinv, einv, v.T.contiguous().T)
    with pytest.raises(ValueError, match="rows"):
        ops.woodbury_apply_raw(b, dinv[:-1].contiguous(), einv, v)
    with pytest.raises(ValueError, match="einv"):
        ops.woodbury_apply_raw(b, dinv, einv[:-1].contiguous(), v)
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        ops.woodbury_apply_raw(b, dinv.cpu(), einv, v)
    # The kernel's limits: rank 1..MAX_RANK; a wider v runs as several launches.
    big = torch.zeros((4, ops.MAX_RANK + 1), device=cuda)
    with pytest.raises(ValueError, match="rank"):
        ops.woodbury_apply_raw(big, dinv[:4].contiguous(),
                               torch.zeros((ops.MAX_RANK + 1,) * 2, device=cuda),
                               v[:4].contiguous())
    assert ops.plan(4000, 128, 1)[5] == 64 * 128


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 37, 4000])
@pytest.mark.parametrize("r", [1, 37, 128, 256, 263])
@pytest.mark.parametrize("cols", [1, 9, 16, 64, 65])
def test_gpu_woodbury_matches_plain_and_repeats(cuda, t, r, cols):
    """Within 1e-5 of the plain version's scale, bit-equal over two calls,
    one launch per launch_cols(r) columns, counted under (T, r, columns).
    B is scaled so that D⁻¹-weighted rows have unit norm: with T < r and
    unit entries, out = w − D⁻¹Bs cancels w to ~1/(1 + 20·r), and float32
    is then far from float64 whatever the summation order (the next test
    holds the kernel to float64 on such draws)."""
    b, dinv, _, v = pieces(t, r, None if cols == 1 else cols, "vector", seed=8)
    b = (b / np.sqrt(r * dinv.max())).astype(np.float32)
    e = np.eye(r) + b.T.astype(np.float64) @ (dinv[:, None] * b)
    einv = np.linalg.inv(e).astype(np.float32)
    arrs = [torch.from_numpy(a).to(cuda) for a in (b, dinv, einv, v)]
    dispatch.reset_launch_counts()
    got = ops.woodbury_apply_raw(*arrs)
    step = ops.launch_cols(r)
    want_shapes = {}
    for c0 in range(0, cols, step):
        key = (t, r, min(step, cols - c0))
        want_shapes[key] = want_shapes.get(key, 0) + 1
    assert dispatch.launch_shapes()["woodbury_apply"] == want_shapes
    close(got, ref.woodbury_apply_ref(*arrs))
    assert torch.equal(got, ops.woodbury_apply_raw(*arrs))


def _rel64(x, want64):
    return float((x.double() - want64).abs().max() / want64.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(1, 64, 16, "masked"), (1, 263, 65, "masked"),
                                  (37, 128, 9, "masked"), (37, 263, 65, "vector")])
@pytest.mark.parametrize("kind", ["random einv", "unit b"])
def test_gpu_woodbury_within_float32s_own_error(cuda, case, kind):
    """Draws on which float32 itself is far from float64: a random E⁻¹
    unrelated to B (rows of B of unit norm; D⁻¹ of the case), and T < r
    with unit-scale B, E⁻¹ = (I + BᵀD⁻¹B)⁻¹ and D⁻¹ near 1, where out
    cancels w to about 1/(1 + r).  Against the float64 result, the kernel's
    mean error over 8 draws is at most twice the plain float32 version's
    plus 1e-5 of scale (two float32 summation orders part by 2-3x on single
    draws), and two calls are bit-equal."""
    t, r, cols, noise = case
    k64, p64 = [], []
    for seed in range(21, 29):
        b, dinv, einv, v = pieces(t, r, cols, "vector" if kind == "unit b" else noise,
                                  seed=seed)
        if kind == "random einv":
            rng = np.random.default_rng(seed + 100)
            b = (b / np.sqrt(r)).astype(np.float32)
            einv = (rng.standard_normal((r, r)) / np.sqrt(r)).astype(np.float32)
        arrs = [torch.from_numpy(a).to(cuda) for a in (b, dinv, einv, v)]
        want64 = ref.woodbury_apply_ref(*(x.double() for x in arrs))
        got = ops.woodbury_apply_raw(*arrs)
        assert torch.equal(got, ops.woodbury_apply_raw(*arrs))
        k64.append(_rel64(got, want64))
        p64.append(_rel64(ref.woodbury_apply_ref(*arrs), want64))
    assert np.mean(k64) <= 2 * np.mean(p64) + TOL


@pytest.mark.gpu
@pytest.mark.parametrize("r", [8192, 8447])
def test_gpu_woodbury_top_ranks(cuda, r):
    """The largest ranks the kernel takes (one column a launch, E⁻¹ read
    from L2, past 512 rows of u a block at r = 8447): within 1e-5 of the
    plain version's scale, bit-equal over two calls."""
    gen = torch.Generator(device=cuda).manual_seed(r)
    t = 37
    b = torch.randn((t, r), generator=gen, device=cuda) / r ** 0.5
    dinv = torch.full((t,), 20.0, device=cuda)
    einv = torch.eye(r, device=cuda) * 0.5 + \
        torch.randn((r, r), generator=gen, device=cuda) * (0.01 / r ** 0.5)
    v = torch.randn((t, 2), generator=gen, device=cuda)
    got = ops.woodbury_apply_raw(b, dinv, einv, v)
    close(got, ref.woodbury_apply_ref(b, dinv, einv, v))
    assert torch.equal(got, ops.woodbury_apply_raw(b, dinv, einv, v))
