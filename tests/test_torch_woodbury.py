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
    # The kernel's own scratch rule: 32-row tiles up to r = 263, fewer past it.
    assert ops._scratch_floats(4000, 128, 1) == (125 + 2) * 128
    assert ops._scratch_floats(100, 1000, 1) == (13 + 2) * 1000
    assert ops._scratch_floats(10, 8448, 1) == -1
    assert ops._scratch_floats(10, 8, 65) == -1
