"""Find a cell's pieces by name.

``BENCHMARK.json`` names the cell's configuration and traffic; everything
else is a file of its own under ``perfbench/``:

* ``configs/<config>.json``   the deployment: graph, walk widths, noise;
* ``traffic/<traffic>.json``  the mix: its ``driver`` and that driver's
                              parameters, the compared numbers' limits;
* ``drivers/<driver>.py``     one general driver per kind of traffic;
* ``metrics/<metric>.py``     one reader per metric, ``read(run)``.

A later change adds a configuration, a mix or a metric as new files plus
entries in ``BENCHMARK.json``, and edits none of these.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    reader: object          # module with read(run) -> float | None


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: object          # module with setup(config, traffic, seed, device)
    end_to_end: tuple
    per_layer: tuple


def load_module(path: Path, name: str):
    """Import one file by path (metric names hold dots, so no package path)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def _metrics(entries, cell: str, root: Path) -> tuple:
    return tuple(
        Metric(e["name"], e["unit"],
               load_module(root / "perfbench" / "metrics" / f"{e['name']}.py",
                           f"perfbench_metric_{e['name']}"))
        for e in entries if _applies(e, cell))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files loaded."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"cells: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "perfbench" / "traffic" / f"{w['traffic']}.json")
    driver = load_module(
        root / "perfbench" / "drivers" / f"{traffic['driver']}.py",
        f"perfbench_driver_{traffic['driver']}")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, driver=driver,
                end_to_end=_metrics(bench["end_to_end"], name, root),
                per_layer=_metrics(bench["per_layer"], name, root))
