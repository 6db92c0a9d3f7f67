"""The benchmark's own tests: on the CPU at small sizes, and, marked
`cuda`, on the card (each decides in a fixture whether one is there).

    python -m pytest -q rtbench/tests                # here
    python -m pytest -q rtbench/tests -m cuda        # on the card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; the test skips where torch has no CUDA "
        "device")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
