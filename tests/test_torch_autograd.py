"""PyTorch port, autograd through the ELL kernels: the three autograd
Functions (Φu, Φᵀv, fused K̂v) against ``jax.vjp`` through the JAX
package's custom VJPs (``spmv_pallas``, ``spmv_t_pallas``, ``khat_pallas``
in interpret mode), and (marked ``gpu``) the Functions on the card against
autograd through their plain versions on the card.

Tolerances: the cotangents are themselves sparse products and gathers of
float32 terms summed in another order: 1e-5 of the result's scale, here
and on the card (where the scatter adds with float atomics).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.ell_spmv import ops, ref  # noqa: E402

TOL = 1e-5

# (M rows, K slots, N nodes, R columns or None for a vector); K̂ cases add
# the second payload's (M_s, K_s).
SPMV = [(40, 12, 64, None), (33, 7, 19, 3), (64, 48, 200, 9)]
KHAT = [(40, 40, 12, 12, 64, None), (30, 17, 7, 9, 50, 3), (64, 64, 48, 48, 300, 9)]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.kernels.ell_spmv import ops as jops

    return jax, jnp, jops


@pytest.fixture
def cuda():
    """The CUDA device; the decision to skip is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def payload(rng, m, k, n):
    vals = rng.standard_normal((m, k)).astype(np.float32)
    vals[rng.random((m, k)) < 0.25] = 0.0
    cols = rng.integers(0, max(2, n // 3), (m, k)).astype(np.int32)  # duplicates
    return vals, cols


def dense(rng, rows, r):
    return rng.standard_normal((rows,) if r is None else (rows, r)).astype(np.float32)


def close(got, want, tol=TOL):
    got = got.detach().cpu().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def torch_grads(fn, args, diff, g):
    """(y, cotangents of the ``diff`` positions of ``args``) by autograd."""
    ts = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    leaves = []
    for i in diff:
        ts[i] = ts[i].clone().requires_grad_()
        leaves.append(ts[i])
    y = fn(*ts)
    return y, torch.autograd.grad(y, leaves, torch.from_numpy(g))


@pytest.mark.parametrize("m,k,n,r", SPMV)
def test_spmv_grad_matches_jax_vjp(jx, m, k, n, r):
    jax, jnp, jops = jx
    rng = np.random.default_rng(m + k + n)
    vals, cols = payload(rng, m, k, n)
    u = dense(rng, n, r)
    g = dense(rng, m, r)
    jc = jnp.asarray(cols)
    y, vjp = jax.vjp(lambda a, b: jops.spmv_pallas(a, jc, b, interpret=True),
                     jnp.asarray(vals), jnp.asarray(u))
    d_vals, d_u = vjp(jnp.asarray(g))
    ty, (t_vals, t_u) = torch_grads(ops.ell_spmv, [vals, cols, u], (0, 2), g)
    close(ty, y)
    close(t_vals, d_vals)
    close(t_u, d_u)


@pytest.mark.parametrize("m,k,n,r", SPMV)
def test_spmv_t_grad_matches_jax_vjp(jx, m, k, n, r):
    jax, jnp, jops = jx
    rng = np.random.default_rng(1 + m + k + n)
    vals, cols = payload(rng, m, k, n)
    v = dense(rng, m, r)
    g = dense(rng, n, r)
    jc = jnp.asarray(cols)
    y, vjp = jax.vjp(
        lambda a, b: jops.spmv_t_pallas(a, jc, b, n, interpret=True),
        jnp.asarray(vals), jnp.asarray(v))
    d_vals, d_v = vjp(jnp.asarray(g))
    ty, (t_vals, t_v) = torch_grads(
        lambda a, c, b: ops.ell_spmv_t(a, c, b, n), [vals, cols, v], (0, 2), g)
    close(ty, y)
    close(t_vals, d_vals)
    close(t_v, d_v)


@pytest.mark.parametrize("mg,ms,kg,ks,n,r", KHAT)
def test_khat_grad_matches_jax_vjp(jx, mg, ms, kg, ks, n, r):
    jax, jnp, jops = jx
    rng = np.random.default_rng(mg + ms + n)
    vg, cg = payload(rng, mg, kg, n)
    vs, cs = payload(rng, ms, ks, n)
    v = dense(rng, ms, r)
    g = dense(rng, mg, r)
    jcg, jcs = jnp.asarray(cg), jnp.asarray(cs)
    y, vjp = jax.vjp(
        lambda a, b, c: jops.khat_pallas(a, jcg, b, jcs, c, n, interpret=True),
        jnp.asarray(vg), jnp.asarray(vs), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    ty, got = torch_grads(
        lambda a, ca, b, cb, c: ops.khat_fused(a, ca, b, cb, c, n),
        [vg, cg, vs, cs, v], (0, 2, 4), g)
    close(ty, y)
    for t, w in zip(got, want):
        close(t, w)


def test_backward_computes_only_requested_cotangents(monkeypatch):
    """A backward that needs only the value cotangents runs no dense-operand
    product: the fit's K̂ backward is two Φᵀ scatters and no fused K̂."""
    rng = np.random.default_rng(0)
    vals, cols = map(torch.from_numpy, payload(rng, 20, 6, 30))
    v = torch.from_numpy(dense(rng, 20, 2))
    calls = []
    for name in ("ell_spmv_raw", "ell_spmv_t_raw", "khat_fused_raw"):
        orig = getattr(ops, name)

        def spy(*a, _orig=orig, _name=name):
            calls.append(_name)
            return _orig(*a)

        monkeypatch.setattr(ops, name, spy)
    a = vals.clone().requires_grad_()
    ops.khat_fused(a, cols, a, cols, v, 30).sum().backward()
    assert calls == ["khat_fused_raw", "ell_spmv_t_raw", "ell_spmv_t_raw"]
    a2 = vals.clone().requires_grad_()
    ref.khat_matvec_ref(a2, cols, a2, cols, v, 30).sum().backward()
    close(a.grad, a2.grad.numpy())


def test_dispatch_casts_stay_differentiable():
    """dispatch's .to(float32).contiguous() keeps the graph to the caller's
    f: d/df of a K̂ matvec through features matches the plain version."""
    rng = np.random.default_rng(1)
    loads = torch.from_numpy(rng.random((25, 8)).astype(np.float32))
    lens = torch.from_numpy(rng.integers(0, 3, (25, 8)).astype(np.int64))
    cols = torch.from_numpy(rng.integers(0, 25, (25, 8)).astype(np.int32))
    v = torch.from_numpy(dense(rng, 25, 4))
    f = torch.tensor([1.0, 0.5, 0.25], requires_grad=True)
    vals = loads * f[lens]
    dispatch.khat_matvec(vals, cols, vals, cols, v, 25).square().sum().backward()
    f2 = f.detach().clone().requires_grad_()
    vals2 = loads * f2[lens]
    ref.khat_matvec_ref(vals2, cols, vals2, cols, v, 25).square().sum().backward()
    close(f.grad, f2.grad.numpy())


# --------------------------------------------------------------------------
# On the card: each Function against autograd through its plain version.
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("r", [None, 9])
def test_gpu_ell_functions_grad_match_plain(cuda, r):
    rng = np.random.default_rng(2)
    n = 5003
    vals, cols = payload(rng, 1037, 48, n)
    vs, cs = payload(rng, 333, 40, n)
    cases = [
        (ops.ell_spmv, ref.ell_spmv_ref, [vals, cols, dense(rng, n, r)], (0, 2), 1037),
        (lambda a, c, b: ops.ell_spmv_t(a, c, b, n),
         lambda a, c, b: ref.ell_spmv_t_ref(a, c, b, n),
         [vals, cols, dense(rng, 1037, r)], (0, 2), n),
        (lambda a, ca, b, cb, c: ops.khat_fused(a, ca, b, cb, c, n),
         lambda a, ca, b, cb, c: ref.khat_matvec_ref(a, ca, b, cb, c, n),
         [vals, cols, vs, cs, dense(rng, 333, r)], (0, 2, 4), 1037),
    ]
    for fn, plain, args, diff, rows in cases:
        g = dense(rng, rows, r)
        args = [torch.from_numpy(a).to(cuda) for a in args]
        gt = torch.from_numpy(g).to(cuda)

        def grads(f):
            ts = list(args)
            leaves = []
            for i in diff:
                ts[i] = ts[i].clone().requires_grad_()
                leaves.append(ts[i])
            return torch.autograd.grad(f(*ts), leaves, gt)

        for got, want in zip(grads(fn), grads(plain)):
            close(got, want.cpu().numpy())
