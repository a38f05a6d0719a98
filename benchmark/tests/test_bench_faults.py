"""``correct`` comes out true on a sound run and false with the timed path
broken underneath, once for each fault a cell can have: a step that
returns its state unchanged, half of the batch left out, an answer
altered where it is produced, and (the mesh) the exchange between ranks
left out. Each runs the rest of a run (set-up, window, the reference's
comparison) at a CPU size."""

import pytest

from benchmark.tests import faults
from benchmark.tests.tiny import run, tiny_cell


def _failed(line):
    return sorted(k for k, v in line["checks"].items()
                  if v["value"] > v["limit"])


def test_sound_run_is_correct():
    line = run(tiny_cell("hopper_seeds8"))
    assert line["correct"], line["checks"]
    assert all(v["value"] == 0 for v in line["checks"].values())


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_answer"])
def test_fault_is_not_correct(fault):
    undo = getattr(faults, fault)()
    try:
        line = run(tiny_cell("hopper_seeds8"))
    finally:
        undo()
    assert not line["correct"]
    assert _failed(line)


def test_mesh_without_exchange_is_not_correct():
    line = run(tiny_cell("humanoidrun_mesh4", Hsample=2),
                  prepare=faults.no_exchange)
    assert not line["correct"]
    assert "rank_mismatch" in _failed(line)
