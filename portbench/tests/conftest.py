"""The benchmark's own tests: run from the root of the checkout with
``python -m pytest portbench/tests -q``.  Tests marked ``gpu`` need the card
and skip inside the test when there is none."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU (skips without CUDA)")
