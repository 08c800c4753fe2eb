"""The benchmark's own tests: on the CPU at tiny sizes, and (marker
``cuda``) on the card.  Run from the root of a checkout:

    python -m pytest benchmark/tests -q            # here: the cuda tests skip
    python -m pytest benchmark/tests -q -m cuda    # on a machine with a card
"""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.dirname(BENCH), BENCH, os.path.dirname(os.path.abspath(__file__))):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (TF32 exists only on the card)")
    return "cuda"


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
