"""The readers that put device-idle gaps down to the program's spans
(``harness/spans.py``): on hand-built traces, and on a traced run of each
tiny cell on the CPU, where the program's spans are profiler ranges but
the device has no intervals."""
import pytest

from perfbench.harness import readers, runner, spans, spec
from perfbench.tools import split

from .test_perfbench_run import CELLS, run

READS = ("solver.cg.read", "walks.column_index")


def _trace(host, device, span=(0.0, 100.0), requests=1):
    return runner.Trace([None] * requests, device, host, span)


class _Run:
    def __init__(self, trace):
        self.trace = trace


def _request():
    """One request, µs: the draw and the prior (busy 0–10), Φ_x's index
    (its build idle 12–20), two CG iterations each with a product (busy
    22–30, 42–50) then a read (idle 30–40, 50–58), the cross product (busy
    60–70); the harness after the request is idle 75–100."""
    host = [("perfbench.request", 0, 75), ("posterior.pathwise", 1, 72),
            ("posterior.draw", 1, 3), ("linops.phi", 3, 5),
            ("features.take_rows", 6, 8), ("linops.khat", 11, 21),
            ("walks.column_index", 12, 20), ("solver.cg", 21, 59),
            ("solver.cg.iter", 21, 24), ("linops.khat", 21, 23),
            ("solver.cg.read", 24, 40), ("solver.cg.iter", 40, 44),
            ("linops.khat", 40, 42), ("solver.cg.read", 44, 58),
            ("linops.khat", 59, 61)]
    device = [("k", 0, 12), ("k", 20, 30), ("k", 40, 50), ("k", 58, 75)]
    return host, device


def test_gaps_are_the_holes_in_the_busy_union():
    host, device = _request()
    assert spans.gaps(_trace(host, device)) == [(12, 20), (30, 40),
                                                 (50, 58), (75, 100)]


def test_gap_begun_under_a_nested_read_goes_to_the_read():
    host, device = _request()
    got = spans.charged(_trace(host, device))
    assert got[1][1] == ("posterior.pathwise", "solver.cg",
                         "solver.cg.read")
    assert spans.idle_innermost_pct(_Run(_trace(host, device)),
                                    "solver.cg.read") == pytest.approx(18.0)


def test_gap_begun_in_the_index_under_a_product_goes_to_the_index():
    host, device = _request()
    got = spans.charged(_trace(host, device))
    assert got[0][1] == ("posterior.pathwise", "linops.khat",
                         "walks.column_index")
    assert spans.idle_innermost_pct(_Run(_trace(host, device)),
                                    "walks.column_index") == pytest.approx(8.0)
    assert spans.idle_innermost_pct(_Run(_trace(host, device)),
                                    "linops.khat") == 0.0


def test_gaps_outside_the_request_go_to_no_program_span():
    host, device = _request()
    t = _trace(host, device)
    assert spans.charged(t)[-1] == (pytest.approx(25e-6), ())
    assert spans.idle_within_pct(_Run(t), spans.ROOT) == pytest.approx(26.0)


def test_a_gap_is_cut_at_the_requests_edges():
    """The gap opened by a request's last read runs on past its root: the
    read keeps it until the root closes, the harness from there, and the
    next request once its root opens."""
    host = [("perfbench.request", 0, 73), ("posterior.pathwise", 1, 72),
            ("solver.cg.read", 65, 71), ("perfbench.request", 78, 100),
            ("posterior.pathwise", 80, 99), ("posterior.draw", 82, 84)]
    device = [("k", 0, 66), ("k", 90, 100)]
    t = _trace(host, device)
    assert spans.pieces(t) == [(66, 72), (72, 80), (80, 90)]
    assert [names for _, names in spans.charged(t)] == [
        ("posterior.pathwise", "solver.cg.read"), (),
        ("posterior.pathwise",)]
    r = _Run(t)
    assert spans.idle_innermost_pct(r, "solver.cg.read") == pytest.approx(6.0)
    assert spans.idle_within_pct(r, spans.ROOT) == pytest.approx(16.0)
    assert readers.idle_pct(r) == pytest.approx(24.0)


@pytest.mark.parametrize("shift", [0, 3, 7])
def test_idle_readers_never_sum_above_the_idle_share(shift):
    """The read and the index sum to no more than the request's idle, which
    is no more than the slice's; gaps moved against the host ranges."""
    host, device = _request()
    device = [(n, s + shift, e + shift) for n, s, e in device]
    r = _Run(_trace(host, device, span=(0.0, 100.0 + shift)))
    read, index = (spans.idle_innermost_pct(r, name) for name in READS)
    within = spans.idle_within_pct(r, spans.ROOT)
    assert read + index <= within + 1e-9 <= readers.idle_pct(r) + 1e-9


def test_readers_find_nothing_without_the_programs_spans():
    """The parent program enters no range of its own: every reader returns
    None, and the line leaves its metric out."""
    host, device = _request()
    bare = [h for h in host if h[0].startswith("perfbench.")]
    r = _Run(_trace(bare, device))
    assert spans.idle_innermost_pct(r, "solver.cg.read") is None
    assert spans.idle_within_pct(r, spans.ROOT) is None
    assert spans.ranges_per_request(r, "walks.column_index") is None
    assert spans.ranges_per_request(_Run(None), "walks.column_index") is None


def test_builds_are_counted_per_request():
    host, device = _request()
    later = [(n, s + 100, e + 100) for n, s, e in host]
    r = _Run(_trace(host + later, device, span=(0.0, 200.0), requests=2))
    assert spans.ranges_per_request(r, "walks.column_index") == 1.0
    assert spans.ranges_per_request(r, "solver.cg.read") == 2.0


def test_split_sums_the_idle_into_its_columns():
    """The split tool's columns: the read, the index, CG's other idle, the
    rest of the request and the harness sum to the slice's idle."""
    host, device = _request()
    t = _trace(host, device)
    got = split.split(t, timeline=0)
    assert got["split_ms_per_request"] == pytest.approx({
        "solver.cg.read": 18e-3, "walks.column_index": 8e-3,
        "cg_iterations": 0.0, "rest_of_request": 0.0, "harness": 25e-3})
    assert got["idle_ms_per_request"] == pytest.approx(
        readers.idle_pct(_Run(t)) * 1e-2 * t.window_s * 1e3)
    assert got["ranges_per_request"]["linops.khat"] == 4.0
    assert got["program_names_among_device_ops"] == []
    assert "timeline" not in got          # one request: no next root
    assert split.group(("posterior.pathwise", "solver.cg",
                        "solver.cg.iter", "linops.khat")) == "cg_iterations"
    assert split.group(("posterior.pathwise", "features.take_rows")) == \
        "rest_of_request"


def test_split_lists_a_requests_pieces_in_order():
    host, device = _request()
    later = [(n, s + 100, e + 100) for n, s, e in host]
    later_dev = [(n, s + 100, e + 100) for n, s, e in device]
    t = _trace(host + later, device + later_dev, span=(0.0, 200.0),
               requests=2)
    got = split.split(t, timeline=0, min_us=0.0)
    assert [row[1:3] for row in got["timeline"]] == [
        [0.008, "walks.column_index"], [0.01, "solver.cg.read"],
        [0.008, "solver.cg.read"], [0.025, "(harness)"]]
    assert got["timeline"][0][3] == "walks.column_index"


@pytest.mark.parametrize("name", CELLS)
def test_traced_tiny_cell_reads_the_programs_spans(name, cpu):
    """The program's spans reach the traced slice on the CPU: one index
    build a request; the idle readers find no device intervals there."""
    _, line = run(name, cpu, trace=True)
    twin = name.split(".")[1]
    m = line["metrics"]
    assert m[f"column_index_builds.{twin}"] == {"value": 1.0,
                                                "unit": "builds"}
    for metric in ("idle_cg_read_pct", "idle_column_index_pct",
                   "idle_in_program_pct"):
        assert f"{metric}.{twin}" not in m


def test_per_layer_sources(bench):
    """A per-layer metric names where its number comes from; the program's
    own spans are one such place."""
    sources = {"device_trace", "program_span", "program_counter",
               "host_clock"}
    assert {m["source"] for m in bench["per_layer"]} <= sources
    spanned = [m for m in bench["per_layer"]
               if m["source"] == "program_span"]
    assert len(spanned) == 8
    for m in spanned:
        cell = spec.load_cell(m["workloads"][0])
        assert m["name"] in {x.name for x in cell.per_layer}
