"""The reader of ``rollout_retire_share`` on recorder contents made by hand
(``mbd_tpu_torch/utils/profiling.py``): its value summed over two ranks,
0 where nothing flags, and None where nothing was counted or where the
program has no retiring form (no ``rollout.retired_sample_steps``)."""

import pytest

from benchmark.harness.spec import load
from mbd_tpu_torch.utils import profiling
from mbd_tpu_torch.utils.profiling import Recorded, Span


@pytest.fixture
def read():
    profiling.clear()
    cell = load("humanoidrun_mesh4")
    yield next(m.read for m in cell.per_layer
               if m.name == "rollout_retire_share")
    profiling.clear()


def _record(windows):
    return dict(plans=1, span_s=10.0, setup_s=3.0, chips=len(windows),
                ranks=[dict(busy_s=w, window_s=w, nccl_s=0.0, ops={})
                       for w in windows])


def _rank(tail=0, retired=None):
    """One rank's recorder contents: a plan and the rollout's counters,
    the retired sample-steps only where ``retired`` is given, as a program
    without the retiring form counts none."""
    counts = {"rollout.sample_steps": 400, "rollout.tail_sample_steps": tail}
    if retired is not None:
        counts["rollout.retired_sample_steps"] = retired
    return Recorded([Span("mbd.plan", None, 0, 0, 0.0, 10.0)], {0: counts})


def test_value_over_two_ranks(read):
    profiling.merge(_rank(tail=100, retired=90), 0)
    profiling.merge(_rank(tail=60, retired=50), 1)
    assert read(_record([10.0, 20.0])) == pytest.approx(140 / 800)


def test_reads_zero_where_nothing_flags(read):
    profiling.merge(_rank(retired=0), 0)
    assert read(_record([10.0])) == 0.0


def test_nothing_recorded(read):
    assert read(_record([10.0])) is None


def test_program_without_the_retiring_form(read):
    # counted, but no retiring launch in the program: nothing to read
    profiling.merge(_rank(tail=100), 0)
    assert read(_record([10.0])) is None
