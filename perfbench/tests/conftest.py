"""pytest settings of the benchmark's own tests (run from the repository
root: `python -m pytest perfbench/tests -q`).

Tests that need a CUDA card carry the `cuda` marker and take the `card`
fixture, which decides there whether a card is present and skips
otherwise; nothing is decided at import."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
