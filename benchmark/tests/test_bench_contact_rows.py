"""The reader of ``rollout_contact_rows`` on recorder contents made by
hand (``mbd_tpu_torch/utils/profiling.py``): the acting contact-row
substeps over the live substeps, summed over two ranks, and None where
nothing was counted or where the program has no such counters."""

import pytest

from benchmark.harness.spec import load
from mbd_tpu_torch.utils import profiling
from mbd_tpu_torch.utils.profiling import Recorded, Span


@pytest.fixture
def read():
    profiling.clear()
    cell = load("humanoidstandup")
    yield next(m.read for m in cell.per_layer
               if m.name == "rollout_contact_rows")
    profiling.clear()


def _record():
    return dict(plans=1, span_s=10.0, setup_s=3.0, chips=1,
                ranks=[dict(busy_s=10.0, window_s=10.0, nccl_s=0.0, ops={})])


def _rank(live=None, rows=None):
    """One rank's recorder contents: a plan and the rollout's counters,
    the live substeps and the acting contact rows only where given, as a
    program without them counts neither."""
    counts = {"rollout.sample_steps": 400, "rollout.tail_sample_steps": 0}
    if live is not None:
        counts["rollout.live_substeps"] = live
    if rows is not None:
        counts["rollout.contact_row_substeps"] = rows
    return Recorded([Span("mbd.plan", None, 0, 0, 0.0, 10.0)], {0: counts})


def test_ratio_over_two_ranks(read):
    profiling.merge(_rank(live=2800, rows=7000), 0)
    profiling.merge(_rank(live=1400, rows=2100), 1)
    assert read(_record()) == pytest.approx(9100 / 4200)


def test_reads_zero_where_no_row_acts(read):
    profiling.merge(_rank(live=2800, rows=0), 0)
    assert read(_record()) == 0.0


def test_nothing_recorded(read):
    assert read(_record()) is None


def test_program_without_the_counters(read):
    # counted, but neither live substeps nor contact rows: a program
    # without the rows buffer
    profiling.merge(_rank(), 0)
    assert read(_record()) is None
    profiling.clear()
    profiling.merge(_rank(rows=5), 0)
    assert read(_record()) is None
