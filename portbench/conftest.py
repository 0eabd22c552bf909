"""pytest settings of the benchmark's own tests (portbench/tests).

Run them from the root of the checkout:

    python -m pytest portbench/tests -q

They run on the CPU and import neither JAX nor the JAX package. Tests
that need the card carry the `cuda` marker and skip without one; whether
a card is there is decided inside a fixture, never at import.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
