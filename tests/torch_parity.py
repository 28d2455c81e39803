"""Helpers shared by the PyTorch-port tests (not collected: no test_ prefix)."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none.

    Decided inside a fixture, at run time, so every test worker collects the
    same tests whatever the machine.
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel is compared with its plain version)")
    return torch.device("cuda:0")


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def seeded(n, d, c, seed=0):
    """(x (n, d), v (n, c)) float32 normal draws from one numpy seed."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(n, c)).astype(np.float32)
