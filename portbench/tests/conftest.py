"""Tests of the port's benchmark.  CPU tests run the harness at a tiny size
with the port's plain versions; tests marked `card` need an NVIDIA card and
skip without one (decided inside the `card` fixture)."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark measures on the card only")
    return torch.cuda.get_device_name(0)
