"""Tests of the benchmark: CPU tests at tiny sizes, and tests marked
`cuda` that need an NVIDIA GPU and skip where there is none (decided in
the `cuda_device` fixture, never at import).

    python -m pytest gpubench/tests -q
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
        "markers", "cuda: needs an NVIDIA GPU; skipped where there is none")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"
