import pytest
import torch

# toy widths: one thread a process is fastest, and keeps a tiny cell's
# window of eager steps short when the tests run in several processes
torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the benchmark's card runs); "
        "skipped without one")


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    return torch.device("cuda")
