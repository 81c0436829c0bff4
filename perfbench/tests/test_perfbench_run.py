"""Whole runs of tiny copies of the cells on the CPU: the result line's
keys, ``correct`` for sound runs, and ``correct`` false for the program's
lower-precision path (the control) and for each fault a sample cell can
have, planted under the timed path."""
import json

import pytest
import torch

from perfbench.harness import cli, runner, spec

from .conftest import tiny

SEED = 2**31 + 4567
CELLS = ("ring-1m.sample", "sphere-1m.track")


def run(name, device, control=False, trace=False, **traffic):
    """A run of the tiny cell: 64 observed nodes from the seed, or the
    configuration's own rule where the cell's traffic takes it."""
    cell = spec.load_cell(name)
    if cell.traffic["observed"] != "config":
        traffic.setdefault("observed", 64)
    cell = tiny(cell, samples=8, **traffic)
    r = runner.run_cell(cell, SEED, 0.3, trace, device, control=control)
    return r, cli.result_line(r, trace, device)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_line(name, cpu):
    r, line = run(name, cpu)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    # peak_mib reads the card's allocator: nothing to read on the CPU
    e2e = {m.name for m in r.cell.end_to_end} - {"peak_mib"}
    assert "setup_s" in e2e and e2e <= set(line["metrics"])
    assert set(line["checks"]) == {"max_err", "rms_err"}
    for c in line["checks"].values():
        assert c["value"] < c["limit"] / 10
    json.loads(json.dumps(line))


@pytest.mark.parametrize("name", CELLS)
def test_traced_line_reads_the_counters(name, cpu):
    _, line = run(name, cpu, trace=True)
    m = line["metrics"]
    assert m[f"cg_iters.{name.split('.')[1]}"]["value"] > 0
    assert "window_s" in line["device"] and "breakdown" in line
    assert "setup_s" not in m


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, cpu):
    _, line = run(name, cpu, control=True)
    assert line["correct"] is False
    assert all(c["value"] > c["limit"] for c in line["checks"].values())


def _solve_unchanged(monkeypatch):
    """A step that returns its state unchanged: the solve hands back its
    starting point, so the correction is never applied."""
    from repro_torch import solvers

    real = solvers.solve

    def solve(h, b, strategy=solvers.SolveStrategy(), **kw):
        res = real(h, b, strategy, **kw)
        return res._replace(x=torch.zeros_like(res.x))

    monkeypatch.setattr(solvers, "solve", solve)


def _half_the_batch(monkeypatch):
    """Half of the observations left out of the solve: their rows of Φ_x
    are emptied, so the posterior conditions on the rest."""
    from repro_torch.core import features

    real = features.take_rows

    def take_rows(trace, rows):
        out = real(trace, rows)
        half = out.loads.shape[0] // 2
        loads = out.loads.clone()
        loads[half:] = 0
        return type(out)(cols=out.cols, loads=loads, lens=out.lens)

    monkeypatch.setattr(features, "take_rows", take_rows)


def _answer_altered(monkeypatch):
    """One sample of one node altered where the samples are produced."""
    from repro_torch.gp import posterior

    real = posterior._pathwise_samples

    def produce(*args):
        samples, iters, conv = real(*args)
        samples = samples.clone()
        samples[samples.shape[0] // 3, 0] += 0.05
        return samples, iters, conv

    monkeypatch.setattr(posterior, "_pathwise_samples", produce)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_solve_unchanged, _half_the_batch,
                                   _answer_altered])
def test_fault_fails(name, fault, cpu, monkeypatch):
    fault(monkeypatch)
    _, line = run(name, cpu)
    assert line["correct"] is False


def test_failed_request_is_counted(cpu, monkeypatch):
    from repro_torch.gp import posterior

    calls = {"n": 0}
    real = posterior.pathwise_samples

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 4:          # set-up warms with the first two
            raise RuntimeError("planted failure")
        return real(*a, **kw)

    monkeypatch.setattr(posterior, "pathwise_samples", flaky)
    _, line = run("ring-1m.sample", cpu)
    assert line["failed"] == 1 and line["correct"] is False


def test_no_card_exits_without_a_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["--workload", "ring-1m.sample", "--seed", str(SEED),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err
