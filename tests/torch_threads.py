"""A fixture for the port's CPU tests: one intra-op thread for PyTorch.

The tests run in several worker processes at once.  PyTorch's default of
one intra-op thread a core then oversubscribes the cores, and its threads
spin at every parallel region: a test that takes 3 s alone took over 100 s
under a loaded run.  The port's tests use small tensors, so one thread
costs them little when alone.  A test module uses it with

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
