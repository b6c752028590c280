"""pytest settings of the benchmark's own tests:
``python -m pytest portbench -q`` from the root of the repository (CPU;
a card only for the tests marked ``card``, which skip without one)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one; run them "
                   "on the card with python -m pytest portbench -m card)")
