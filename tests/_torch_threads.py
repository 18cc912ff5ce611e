"""One torch intra-op thread for a test module of the port.

The tier-1 run spreads the test files over several worker processes on one
machine; with every process's default intra-op thread pool, the port's heavy
modules (many small products, small training runs) ran many times slower than
alone.  A module opts in by importing the fixture::

    from _torch_threads import _one_intra_op_thread  # noqa: F401

It is module-scoped and autouse, and restores the thread count after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
