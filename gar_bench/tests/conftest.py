"""Settings of the benchmark's own tests (``python -m pytest gar_bench/tests``):
the ``gpu`` marker of tests that need a CUDA card (they skip inside the test
when there is none), one torch thread a test process."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
