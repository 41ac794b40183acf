"""The port's tests under one torch thread.

A test module of the port imports the fixture, which pytest then runs for
every test of that module::

    from torch_threads import _one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module's tests and fixtures: these ops are
    small, and the suite's parallel workers, each with a pool of every
    core's threads, slow them down by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
