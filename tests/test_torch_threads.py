"""One intra-op thread for the port's CPU parity tests.

Their tensors are a few kilobytes: torch's thread pool spends more on
waking and joining its threads than on the work, and under pytest-xdist
every worker's pool competes for the same cores. Each test file of the
port imports ``one_torch_thread``, which holds torch at one intra-op
thread for the file's tests and restores the count after them.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_one_intra_op_thread_during_the_tests():
    assert torch.get_num_threads() == 1
