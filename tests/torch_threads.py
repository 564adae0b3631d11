"""The ``_one_thread`` fixture of the port's test files.

The suite runs files in parallel processes (``-n 6`` on 8 cores), where
torch's intra-op pool and numpy's OpenBLAS pool, each as wide as the host,
would oversubscribe the cores. A test file imports the fixture::

    from torch_threads import _one_thread  # noqa: F401

and every test in it then runs on one thread of each pool. The numbers do
not change: a test compares values computed in one process.
"""

import pytest
import torch
from threadpoolctl import threadpool_limits


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch intra-op thread and one BLAS thread for the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)
