"""The control comes out not correct: the reference put in the program's
place with its barycenters formed from TF32-rounded operands, judged by
the benchmark's own comparison, at a CPU size (``control.py`` runs the
same on the card at a cell's size)."""

from benchmark.reference.planner import tf32
from benchmark.tests.control import judged
from benchmark.tests.tiny import SEED, output, tiny_cell

import torch


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0e-5,
                      float("inf")])
    y = tf32(x)
    bits = y[:3].view(torch.int32)
    assert torch.all(bits & 0x1FFF == 0)
    assert y[0] == 1.0 + 2 ** -10           # a tie rounds away from zero
    assert y[1] == 1.0 + 2 ** -10
    assert y[3] == float("inf")


def test_control_is_not_correct():
    cell = tiny_cell("humanoidrun")
    line, control = judged(cell, SEED, output(cell), "cpu")
    assert line["correct"], line["checks"]
    assert not control["correct"], control["checks"]
    failed = {k for k, v in control["checks"].items()
              if v["value"] > v["limit"]}
    assert failed & {"first_step_gap", "step_gap"}, control["checks"]
