"""Nothing the harness or the reference imports is JAX or the JAX package,
compared by whole top-level names, and the reference imports nothing of
the port."""
import ast
import subprocess
import sys

import pytest

from perfbench.harness import cli

from .conftest import ROOT

PKG = ROOT / "perfbench"


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] in cli.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch.gp", sys)
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    assert cli.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.gp", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert cli.forbidden_modules() == ["jax", "repro"]


SCRIPT = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
{imports}
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def loaded_after(imports: str) -> set:
    code = SCRIPT.format(root=str(ROOT), src=str(ROOT / "src"),
                         imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_a_whole_tiny_run_loads_no_jax():
    mods = loaded_after(
        "import torch\n"
        "from perfbench.harness import spec, runner, cli\n"
        "from perfbench.tests.conftest import tiny\n"
        "for name in ('ring-1m.sample', 'sphere-1m.track'):\n"
        "    cell = tiny(spec.load_cell(name), samples=4)\n"
        "    runner.run_cell(cell, 5, 0.1, True, torch.device('cpu'))\n"
        "assert not cli.forbidden_modules()\n")
    assert not mods & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in mods


def test_reference_imports_nothing_of_the_port():
    mods = loaded_after("import perfbench.reference.gp, "
                        "perfbench.reference.walks, "
                        "perfbench.reference.compare")
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")) +
                         sorted((PKG / "graphs").glob("*.py")))
def test_yardstick_sources_import_no_program(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax",
                        "benchmarks"}
