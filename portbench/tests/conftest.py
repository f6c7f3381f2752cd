"""Fixtures of the benchmark's own tests (run with
``python -m pytest portbench/tests``; the repo's ``tests/`` does not
collect them). Tests that need the card carry the ``cuda`` marker and skip
in the ``cuda_device`` fixture where there is none."""

import pytest
import torch


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
