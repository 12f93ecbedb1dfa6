"""Torch's CPU threads for the port's tests (``tests/test_torch_*.py``
import the fixture below).

Under pytest-xdist each worker would run torch's intra-op pool with a
thread per core. The port's tests run small shapes: many short ops, each
ending at a barrier of its pool, so with six workers on eight cores the
pools' threads spin and wait on each other's preemption.
``tests/test_torch_staged.py`` beside seven busy processes on an 8-core
CPU took 308 s with eight threads and 75 s with one. The fixture gives
each worker its share of the cores for a module and restores the count
after it.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
