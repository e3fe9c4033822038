"""torch on one thread for the tests of a module of the port's tests.

The tier-1 command runs six pytest workers at once. torch's intra-op pool
starts a thread per core in each of them, and together the pools
oversubscribe the cores: the torch work of a test then runs many times
slower than alone, and so does the JAX work beside it in the other
workers (a fixed-point table test took 242 s there on 8 threads, 3 s
alone on one). A test module imports `one_torch_thread`, an autouse
fixture of module scope, and its tests run torch on one thread.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
