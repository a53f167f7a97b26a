"""The benchmark's own tests, run apart from the repository's suite:

    python -m pytest benchmark/tests -q

Tests that need a CUDA card carry the ``cuda`` marker and skip without
one, deciding inside the test.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [os.path.dirname(BENCH), BENCH]


def pytest_configure(config):
    import torch
    torch.set_num_threads(1)     # the tests' tensors are tiny
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips itself without one")
