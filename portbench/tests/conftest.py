"""The benchmark's CPU tests import ``portbench`` from the checkout's root
and the port from ``src``, and run the tiny models on two threads (put
back after each test), so that parallel test workers do not oversubscribe
the CPU."""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(saved)
