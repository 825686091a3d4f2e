"""Port tests: one torch thread, one BLAS and OpenMP thread per process, and
the card fixture.

The parent ``tests/conftest.py`` pins JAX to the CPU with x64, which is how
the reference side of every comparison here runs. The thread policy of
``thread_policy.py`` is applied here as well as in the root ``conftest.py``,
because the card runs the port tests with ``--confcutdir=tests/port``, which
loads neither parent."""

from thread_policy import one_thread_per_pool

one_thread_per_pool()

import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is no card. Tests
    that take it carry the ``gpu`` marker."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
