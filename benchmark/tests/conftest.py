"""The benchmark's own tests: on the CPU at tiny sizes, and (marked ``card``)
on a CUDA card at the cells' own sizes.

    python -m pytest benchmark/tests -q            # here: the card tests skip
    python -m pytest benchmark/tests -q -m card    # on the card
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """Skip the test without a CUDA card (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")

