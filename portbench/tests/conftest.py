"""The harness's tests run on the CPU at tiny sizes; those marked
``cuda`` need a card and decide inside the test whether to skip."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc; skips elsewhere")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"
