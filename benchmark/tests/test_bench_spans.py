"""The readers of the program's spans and counters, on recorder contents
made by hand (``mbd_tpu_torch/utils/profiling.py``): each gives its value,
and None where nothing was recorded; ``gather_wait_share`` None on one
rank."""

import pytest

from benchmark.harness.spec import load
from mbd_tpu_torch.utils import profiling
from mbd_tpu_torch.utils.profiling import Recorded, Span

NAMES = ("prologue_share", "gather_wait_share", "rollout_tail_share")


@pytest.fixture
def read():
    profiling.clear()
    cell = load("humanoidrun_mesh4")
    yield {m.name: m.read for m in cell.per_layer if m.name in NAMES}
    profiling.clear()


def _record(windows):
    return dict(plans=1, span_s=10.0, setup_s=3.0, chips=len(windows),
                ranks=[dict(busy_s=w, window_s=w, nccl_s=0.0, ops={})
                       for w in windows])


def _rank(gather_ms, prologue_s=0.5, step_s=(1.0, 2.0), tail=0):
    """One rank's recorder contents: a plan with its prologue, two steps
    and their children, a gather a step, and the rollout's counters."""
    spans = [Span("mbd.plan", None, 0, 0, 0.0, 10.0),
             Span("mbd.prologue", 0, 0, 0, 0.0, prologue_s)]
    t = prologue_s
    for k, (sec, ms) in enumerate(zip(step_s, gather_ms)):
        spans.append(Span("mbd.step", 0, 0, 0, t, t + sec, dict(t=k)))
        step = len(spans) - 1
        spans.append(Span("mbd.rollout", step, 0, 0, t, t + sec))
        spans.append(Span("mesh.gather", len(spans) - 1, 0, 0, t, t + 0.1,
                          dict(bytes=8), device_ms=ms))
        t += sec
    return Recorded(spans, {0: {"rollout.sample_steps": 400,
                                "rollout.tail_sample_steps": tail}})


def test_values_over_two_ranks(read):
    profiling.merge(_rank([3.0, 1.0], prologue_s=0.5, tail=100), 0)
    profiling.merge(_rank([1.0, 4.0], prologue_s=0.2, step_s=(2.0, 4.0),
                          tail=60), 1)
    record = _record([10.0, 20.0])
    assert read["prologue_share"](record) == pytest.approx(0.05)
    # least a call: 1.0, 1.0; waits: rank 0 2.0 ms, rank 1 3.0 ms
    assert read["gather_wait_share"](record) == pytest.approx(
        max(2.0e-3 / 10.0, 3.0e-3 / 20.0))
    assert read["rollout_tail_share"](record) == pytest.approx(160 / 800)


def test_nothing_recorded(read):
    record = _record([10.0])
    for name in NAMES:
        assert read[name](record) is None, name


def test_gather_wait_share_needs_two_ranks(read):
    profiling.merge(_rank([3.0, 1.0]), 0)
    record = _record([10.0])
    assert read["gather_wait_share"](record) is None
    assert read["prologue_share"](record) == pytest.approx(0.05)
    assert read["rollout_tail_share"](record) == 0.0
