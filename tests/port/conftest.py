"""Port tests: one torch thread, one BLAS thread per test, and the card
fixture.

The parent ``tests/conftest.py`` pins JAX to the CPU with x64, which is how
the reference side of every comparison here runs."""

import importlib.util

import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """The host numpy code factorizes many small matrices, where a
    multi-threaded BLAS only adds overhead (and oversubscribes the cores
    under parallel test workers). Scoped to the port tests."""
    if importlib.util.find_spec("threadpoolctl") is None:
        yield
        return
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is no card. Tests
    that take it carry the ``gpu`` marker."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
