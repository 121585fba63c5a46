"""CPU tests of the benchmark harness, at sizes a test run holds.

    python -m pytest portbench/tests -q

Tests that need an NVIDIA card carry the `card` marker and skip here; on
the card's machine the same command runs them.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch sees no CUDA device)")
    return torch.device("cuda", 0)

