"""Fixtures of the benchmark's CPU tests: a tiny checkout root whose
BENCHMARK.json names the real cells over tiny configurations, so that a
whole run goes through the harness on the CPU in seconds.

    python -m pytest lavbench/tests -q

Tests marked `card` need an NVIDIA card and skip without one (run them
on the card with the same command)."""

import pytest

from lavbench.tests.helpers import tiny_root


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return "cuda"


@pytest.fixture
def tiny(tmp_path):
    import torch

    torch.set_num_threads(2)
    return tiny_root(tmp_path / "checkout")
