"""BENCHMARK.json against its contract, and every piece found by name."""
import re

import pytest

from perfbench.harness import spec

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["perfbench"]
    assert bench["command"] == ["python3", "perfbench/run.py"]


def test_check_fits_the_day(bench):
    """A full check with 24 cells: (2 + 14·24) runs of run_seconds + 60 s,
    2·90 s of compilation per cell and 1200 s spare fit in 43200 s."""
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entry_keys(bench):
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert UNIT.match(m["unit"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_every_cell_reports_what_the_contract_asks(bench):
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        e2e = {m.name for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in bench["per_layer"]:
            if w["name"] in m.get("workloads", [w["name"]]):
                assert m["moves"] in e2e
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


@pytest.mark.parametrize("kind", ["configs", "traffic", "drivers", "metrics"])
def test_pieces_are_found_by_name(bench, kind):
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        if kind == "configs":
            assert cell.config["name"] == w["config"]
        elif kind == "traffic":
            assert "limits" in cell.traffic
        elif kind == "drivers":
            assert callable(cell.driver.setup) and callable(cell.driver.work)
        else:
            for m in cell.end_to_end + cell.per_layer:
                assert callable(m.reader.read)


def test_missing_cell_names_the_cells():
    with pytest.raises(KeyError, match="ring-1m.sample"):
        spec.load_cell("no-such-cell")
