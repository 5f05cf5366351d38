"""Tests of the benchmark harness. Those marked ``card`` need a CUDA
device and skip without one (they decide inside the test):

    python -m pytest perfbench/tests -q            # the CPU tests
    python -m pytest perfbench/tests -q -m card    # on the card
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")
    # Tests run in several worker processes at once: one thread each keeps
    # the CPU's convolutions from contending for the cores.
    import torch
    torch.set_num_threads(1)
