"""The benchmark's own tests: `python3 -m pytest benchmark/tests -q` from the
root of the repository. Tests marked `card` need a CUDA card and skip
without one; on the card they run with the rest."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: runs on the card")
    return "cuda"
