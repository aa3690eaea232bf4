"""Tests of the benchmark (``python -m pytest port_bench/tests -q``).

Tests that need a card carry the ``cuda`` marker and skip without one; they
decide inside a fixture, never at import.  On a card:
``python -m pytest port_bench/tests -m cuda -q``.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
