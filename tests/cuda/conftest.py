"""Tests of the port's CUDA kernels on the card.

They carry the ``cuda`` marker and skip, with a reason, where there is no
CUDA device. They import neither jax nor the reference package, so on a
machine with a card and without jax they run on their own, without the
suite's conftest one directory up:

    python -m pytest -q -p no:cacheprovider --confcutdir=tests/cuda tests/cuda
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of csrc/ run only on "
                    "the card")
    return torch.device("cuda", torch.cuda.current_device())
