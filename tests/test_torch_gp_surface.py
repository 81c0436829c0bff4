"""PyTorch port, the public surface of ``repro_torch.gp``: the same names as
``repro.gp``, the ``gp.cg`` deprecation shim over ``solvers``, and
``gp.posterior_moments`` over the serving state."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.gp as tgp  # noqa: E402
from repro_torch import solvers  # noqa: E402

# Names of repro.gp whose modules the port has not ported yet: none.
NOT_PORTED = set()


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")}


def test_gp_exports_the_reference_names():
    pytest.importorskip("jax")
    import repro.gp as jgp

    assert _public(tgp) == _public(jgp) - NOT_PORTED
    import repro.gp.cg as jcg

    assert _public(tgp.cg) - {"annotations", "functools", "warnings"} == \
        _public(jcg) - {"annotations", "functools", "warnings"}


def test_cg_shim_warns_once_and_solves_like_solvers(monkeypatch):
    monkeypatch.setattr(tgp.cg, "_WARNED", False)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((12, 12)).astype(np.float32)
    a = torch.from_numpy(a @ a.T + 12 * np.eye(12, dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal(12).astype(np.float32))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = tgp.cg_solve(lambda x: a @ x, b, tol=1e-6)
        tgp.cg.cg_solve_fixed(lambda x: a @ x, b, 3)
    assert [w.category for w in caught] == [DeprecationWarning]
    want = solvers.cg_solve(lambda x: a @ x, b, tol=1e-6)
    assert torch.equal(got.x, want.x) and got.iters == want.iters
    assert tgp.CGResult is solvers.CGResult and tgp.solve is solvers.solve
    assert tgp.cg.SolveStrategy is solvers.SolveStrategy


def test_gp_posterior_moments_is_the_serving_states():
    from repro_torch import serving
    from repro_torch.core import modulation, walks
    from repro_torch.graphs import generators

    g = generators.ring(400, k=2, device="cpu")
    mod = modulation.diffusion(4)
    f = mod(mod.init(device="cpu"))
    state = serving.init_state(g, 3, f, 0.05, 16, walks.WalkConfig(4, 0.3, 4))
    nodes = list(range(0, 400, 40))
    state = serving.observe_batch(state, nodes, [float(np.sin(x / 30)) for x in nodes])
    q = torch.tensor([5, 77, 301], dtype=torch.int32)
    for a, b in zip(tgp.posterior_moments(state, q),
                    serving.posterior_moments(state, q)):
        assert torch.equal(a, b)
