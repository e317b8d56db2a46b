"""The benchmark's CPU tests run tiny models: one intra-op thread each is
faster than contending for every core beside the other test workers."""
import pytest


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
