"""A module fixture for the port's CPU tests: one torch thread while the
module runs. The suite runs in parallel workers, and a many-threaded torch
in each worker oversubscribes the cores; the results the tests compare
hold at any thread count (both sides of each bit-for-bit comparison run
under the same one)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
