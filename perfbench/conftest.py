"""pytest settings of the benchmark's own tests (``perfbench/tests``).

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which decides at run time, never at import, whether CUDA is
there, and skips where it is not.

Each test process runs torch's CPU operations on one thread: the tiny
runs are timed windows, and several test processes that each start a
thread a core leave every window few steps.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skipped without CUDA)")
    import torch
    torch.set_num_threads(1)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "false")
    return "cuda"
