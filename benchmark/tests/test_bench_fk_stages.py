"""The reader of ``rollout_fk_stages`` on recorder contents made by hand
(``mbd_tpu_torch/utils/profiling.py``): the serial steps of forward
kinematics over the live substeps, summed over two ranks, and None where
nothing was counted or where the program has no such counter."""

import pytest

from benchmark.harness.spec import load
from mbd_tpu_torch.utils import profiling
from mbd_tpu_torch.utils.profiling import Recorded, Span


@pytest.fixture
def read():
    profiling.clear()
    cell = load("humanoidrun")
    yield next(m.read for m in cell.per_layer
               if m.name == "rollout_fk_stages")
    profiling.clear()


def _record():
    return dict(plans=1, span_s=10.0, setup_s=3.0, chips=1,
                ranks=[dict(busy_s=10.0, window_s=10.0, nccl_s=0.0, ops={})])


def _rank(live=None, stages=None):
    """One rank's recorder contents: a plan and the rollout's counters,
    the live substeps and the forward kinematics' steps only where given,
    as a program without them counts neither."""
    counts = {"rollout.sample_steps": 400, "rollout.tail_sample_steps": 0}
    if live is not None:
        counts["rollout.live_substeps"] = live
    if stages is not None:
        counts["rollout.fk_stage_substeps"] = stages
    return Recorded([Span("mbd.plan", None, 0, 0, 0.0, 10.0)], {0: counts})


def test_stages_a_live_substep_over_two_ranks(read):
    # the humanoid's 6 tree levels on both ranks
    profiling.merge(_rank(live=2800, stages=6 * 2800), 0)
    profiling.merge(_rank(live=1400, stages=6 * 1400), 1)
    assert read(_record()) == 6.0


def test_a_chain_reads_its_bodies(read):
    # hopper: 4 bodies one after another on lane 0
    profiling.merge(_rank(live=2000, stages=4 * 2000), 0)
    assert read(_record()) == 4.0


def test_nothing_recorded(read):
    assert read(_record()) is None


def test_program_without_the_counter(read):
    # counted, but no forward kinematics' steps: a program without them
    profiling.merge(_rank(live=2800), 0)
    assert read(_record()) is None
    profiling.clear()
    profiling.merge(_rank(), 0)
    assert read(_record()) is None
