"""PyTorch port, package rules: no JAX and nothing of the JAX package inside
``src/repro_torch`` or ``chip_smoke.py``; the card is the default device and
its absence raises; chip_smoke.py refuses to run without a card or outside
the repository."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)(\.|\s|,|$)|from\s+(jax|repro)(\.|\s))", re.M)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_every_module_imports_without_jax_or_repro():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py")
    )
    modules = [m.removesuffix(".__init__") for m in modules]
    script = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(" + repr(modules) + "))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(modules) >= 20


def test_sources_never_import_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert offenders == []
    # The pattern does catch what it is meant to catch.
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.core import walks", "import repro", "  from repro import x"):
        assert _FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import walks",
                 "import jaxtyping"):
        assert not _FORBIDDEN.search(line), line


def test_default_device_is_the_card():
    """Entry points default to CUDA and raise, never fall back, without it."""
    from repro_torch import device, interop
    from repro_torch.core import modulation
    from repro_torch.graphs import generators

    calls = [
        lambda: generators.ring(10),
        lambda: generators.grid2d(3, 3),
        lambda: modulation.diffusion(3).init(),
        lambda: interop.trace_from_numpy([[0]], [[1.0]], [[0]]),
    ]
    if torch.cuda.is_available():
        assert generators.ring(10).neighbors.device.type == "cuda"
        assert device.resolve().type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert generators.ring(10, device="cpu").neighbors.device.type == "cpu"
    assert device.resolve("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_outside_its_conditions(tmp_path):
    """Alone in a directory it fails with no result line; here, without a
    card (or without the checkout), it fails too."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                             cwd=ROOT, env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0 and '"ok"' not in out.stdout
        assert "no CUDA device" in out.stderr
