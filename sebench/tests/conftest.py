"""Tests of the benchmark.  ``card`` marks the tests that need a CUDA
device; whether one is present is decided inside the ``card`` fixture,
never while a module is imported."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (runs on the chip)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: run on the chip")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
