"""Pytest settings of the benchmark's tests.

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which decides at run time whether a CUDA device is present and
skips with a reason where it is not (here, on a machine with no card).
Run them on the card with ``python -m pytest -m card bench/tests``.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips where none is present)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's card tests run on the H100")
    return torch.device("cuda")
