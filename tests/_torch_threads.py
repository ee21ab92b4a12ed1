"""One intra-op thread for the port's CPU tests.

The port's CPU tests push small tensors (batch 2, widths of a few hundred)
through PyTorch's CPU kernels. With one intra-op thread such a matmul runs
many times faster than with a thread per core, where starting and joining
the threads costs more than the work; and the ``pytest -n`` workers then
leave each other, and the engine's wall-clock tests, their cores. A test
module applies it by importing ``one_torch_thread``.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
