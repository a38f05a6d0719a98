"""Each metric's reader, on a record made by hand: the value, and nothing
where there is nothing to read (never a 0 for a share of a peak)."""

import pytest

from benchmark.harness.spec import load
from benchmark.work.count import PEAK_FLOPS


def _readers():
    cell = load("humanoidrun_mesh4")
    return {m.name: m.read for m in cell.end_to_end + cell.per_layer}


def _record(ranks, chips=2):
    return dict(plans=2, span_s=10.0, setup_s=3.0, chips=chips,
                work=dict(needed_ops=PEAK_FLOPS * 0.5, least_s=0.4),
                ranks=ranks)


def test_values():
    read = _readers()
    ranks = [dict(busy_s=4.0, window_s=5.0, nccl_s=0.5, ops={}),
             dict(busy_s=4.5, window_s=5.0, nccl_s=0.0, ops={})]
    record = _record(ranks)
    assert read["plan_s"](record) == pytest.approx(5.0)
    assert read["setup_s"](record) == pytest.approx(3.0)
    assert read["idle_share"](record) == pytest.approx(0.2)
    assert read["nccl_share"](record) == pytest.approx(0.1)
    assert read["mfu"](record) == pytest.approx(100 * 0.5 / 5.0 / 2)
    assert read["rollout_roofline"](record) == pytest.approx(100 * 0.4 / 8.5)


def test_nothing_to_read():
    read = _readers()
    untraced = _record([])
    for name in ("idle_share", "nccl_share", "mfu", "rollout_roofline"):
        assert read[name](untraced) is None
    one_card = _record([dict(busy_s=4.0, window_s=5.0, nccl_s=0.0, ops={})])
    assert read["nccl_share"](one_card) is None


def test_busy_time_is_the_union_and_gaps_its_complement():
    from benchmark.harness import trace

    spans = [(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (7.0, 8.0)]
    busy = trace.merged(spans)
    assert busy == [(0.0, 3.0), (5.0, 8.0)]
    assert sum(b - a for a, b in busy) == pytest.approx(6.0)
    assert trace.gaps(busy, -1.0, 10.0) == [(-1.0, 0.0), (3.0, 5.0),
                                            (8.0, 10.0)]
    ops = {"ncclDevKernel_AllReduce": [3, 0.25], "rollout_kernel": [2, 1.0]}
    assert trace.named_s(ops, "NCCL") == pytest.approx(0.25)
