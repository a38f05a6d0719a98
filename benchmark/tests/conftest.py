"""The benchmark's own tests, on the CPU: ``python -m pytest benchmark/tests
-q``. Tests marked ``cuda`` need a card and skip without one; whether one
is there is decided inside the ``card`` fixture, never at import."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card's machine")
    return torch.device("cuda:0")
