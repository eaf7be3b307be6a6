"""Tests of the benchmark's harness. They run on the CPU at a tiny size
(``tiny.py``); those marked ``card`` need an NVIDIA card and skip without
one, deciding inside a fixture:

    python -m pytest benchmark/tests -q            # here
    python -m pytest benchmark/tests -q -m card    # on the card
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the comparison at the cell's own size runs on the card")
    return "cuda"


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """A registry over a copy of the benchmark cut to a CPU's size."""
    import torch

    from benchmark.tests.tiny import tiny_copy

    torch.set_num_threads(min(4, torch.get_num_threads()))
    return tiny_copy(str(tmp_path_factory.mktemp("bench")))
