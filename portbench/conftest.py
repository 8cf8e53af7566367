"""The benchmark's own tests: ``python -m pytest portbench -q`` (on a card
the tests marked ``card`` run too; elsewhere they skip)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none (decided
    when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
