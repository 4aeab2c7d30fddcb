"""Settings of the benchmark's own tests (python -m pytest benchmark/tests).

They run on the CPU at small sizes, with the port's plain versions.
Tests marked ``cuda`` need a card and skip without one; whether there
is one is decided inside a fixture, never while a module is imported.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and the CUDA toolkit; skips "
        "where torch.cuda.is_available() is false")


@pytest.fixture(autouse=True)
def _skip_without_card(request):
    if request.node.get_closest_marker("cuda") is not None:
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (run on the card)")
