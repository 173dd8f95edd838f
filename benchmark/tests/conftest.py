"""Settings of the benchmark's own tests: the ``card`` marker, for tests
that need a CUDA card, which skip elsewhere (decided in the ``card``
fixture, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda:0")
