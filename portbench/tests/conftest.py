"""Fixtures of the benchmark's tests. Tests that need the card are marked
`cuda` and skip inside the `cuda_device` fixture when none is present."""

import pytest


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)
