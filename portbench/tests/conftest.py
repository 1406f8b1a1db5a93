"""The benchmark's own tests: ``python -m pytest portbench/tests -q``.

Tests marked ``card`` need a CUDA device (run them on the chip, from the
root of a checkout: ``python -m pytest portbench/tests -q -m card``); they
decide inside the test whether one exists and skip with the reason here.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (runs on the chip)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip")
    return torch.device("cuda", 0)
