"""Shared helpers for the port's tests (``tests/test_torch_*.py``).

The tests run the port on the CPU (its plain PyTorch versions) against the
JAX package on the same numpy inputs.  Tests of the CUDA kernels carry the
``cuda`` marker and skip, inside the test, when no card is present.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def port_on_cpu():
    """Run the port on the CPU with few threads (tier-1 runs many
    workers)."""
    from jtk_tpu_torch.runtime import use_device
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with use_device("cpu"):
        yield
    torch.set_num_threads(threads)


def require_cuda():
    """Skip the calling test unless a CUDA device is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
