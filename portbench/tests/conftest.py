"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
repository root, on the CPU (a few minutes). Tests marked ``card`` run a
cell on a CUDA card and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs on a CUDA card; skips without one")


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
