"""The work counts against hand counts on a tiny trace."""
import pytest
import torch

from perfbench.drivers import common, pathwise
from perfbench.harness import work
from perfbench.harness.runner import Output


def tiny_trace():
    # 4 nodes, K = 3; loads 0 mark halted slots.
    cols = torch.tensor([[0, 1, 1], [1, 2, 3], [2, 2, 0], [3, 0, 1]],
                        dtype=torch.int32)
    loads = torch.tensor([[1., 1., 0.], [1., 0., 1.], [1., 1., 1.],
                          [1., 0., 0.]])
    return cols, loads


def test_trace_problem_by_hand():
    cols, loads = tiny_trace()
    p = common.trace_problem(cols, loads, torch.tensor([1, 3]))
    # live slots: row0 {0,1}, row1 {1,3}, row2 {2,2,0}, row3 {3}
    assert p["nnz"] == 8 and p["touched"] == 4 and p["k"] == 3
    # rows 1 and 3: slots {1, 3} and {3}; they touch columns {1, 3}
    assert p["nnz_x"] == 3 and p["touched_x"] == 2
    # whole trace's live slots on columns 1 or 3: row0 1, row1 1 and 3, row3 3
    assert p["hits_x"] == 4


def test_spmv_and_khat_counts_by_hand():
    assert work.spmv(nnz=8, touched_rows=4, out_rows=4, r=2) == (
        8 * 8 + 4 * 2 * 8, 2 * 8 * 2)
    # K̂_xx read once: 3 slots; v and y of 2 rows × R 2.
    assert work.khat(3, 2, 3, 3, 2, 2, shared=True) == (8 * 3 + 4 * 2 * 4,
                                                        2 * 2 * 6)
    # the cross: Φ_x's 3 slots and Φ's 8; v 2 rows in, y 4 rows out.
    assert work.khat(3, 2, 8, 4, 4, 2, shared=False) == (8 * 11 + 4 * 2 * 6,
                                                         2 * 2 * 7)


def test_least_time_takes_the_larger_bound():
    assert work.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.least_s(0, 67e12) == pytest.approx(1.0)
    assert work.least_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_request_work_counts_cg_products():
    p = {"n": 4, "t": 2, "s": 2, "k": 3, "nnz": 8, "touched": 4,
         "nnz_x": 3, "touched_x": 2, "hits_x": 4}
    one = pathwise.work(p, Output(0, None, [1], 1))
    five = pathwise.work(p, Output(0, None, [5], 1))
    kxx = work.least_s(*work.khat(3, 2, 3, 3, 2, 2, shared=True))
    assert five["khat_fused"] - one["khat_fused"] == pytest.approx(4 * kxx)
    assert five["call"] == one["call"] and five["ell_spmv"] == one["ell_spmv"]
