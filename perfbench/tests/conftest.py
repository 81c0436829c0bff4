"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest -q perfbench/tests``; the repository's suite does not
collect this folder).  Tiny copies of the cells run on the CPU, where the
program takes its plain PyTorch versions."""
import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench.harness import spec  # noqa: E402


def tiny(cell, **traffic):
    """The cell at a size a CPU test holds: 3000 nodes, 10 walkers with
    l_max 8, and what ``traffic`` overrides."""
    cfg = json.loads(json.dumps(cell.config))
    tr = json.loads(json.dumps(cell.traffic))
    cfg["graph"]["n_nodes"] = 3000
    cfg["walks"] = {"n_walkers": 10, "p_halt": 0.1, "l_max": 8}
    tr.update(traffic)
    return dataclasses.replace(cell, config=cfg, traffic=tr)


@pytest.fixture
def cpu():
    return torch.device("cpu")


@pytest.fixture
def card():
    """The CUDA card, decided here and not at import: skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def bench():
    return spec.load_json(ROOT / "BENCHMARK.json")
