"""The benchmark's CPU tests: ``python -m pytest h100_bench/tests -q`` from
the repository's root. Tests marked ``card`` need a CUDA card and skip
without one (decided inside the ``card`` fixture)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the chip")
