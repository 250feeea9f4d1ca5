"""Tests of the benchmark harness. CPU tests run anywhere; tests marked
``card`` need a CUDA device and skip without one (decided in the ``card``
fixture, never at import). Run them with::

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
