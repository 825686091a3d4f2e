"""The thread policy of ``thread_policy.py``: one BLAS and OpenMP thread in
every pool, already inside a module-scoped fixture (pytest sets those up
before any function-scoped one). It runs in the whole suite, where the root
``conftest.py`` applies the policy at import, and with the port tests alone
(``--confcutdir=tests/port``, as on the card), where only
``tests/port/conftest.py`` applies it."""

import pytest


@pytest.fixture(scope="module")
def pools():
    threadpoolctl = pytest.importorskip("threadpoolctl")
    import numpy  # noqa: F401  (the pools the host code uses)
    import scipy.linalg  # noqa: F401
    import torch  # noqa: F401

    return threadpoolctl.threadpool_info()


def test_every_blas_and_openmp_pool_runs_one_thread(pools):
    assert any(p["user_api"] == "blas" for p in pools)
    wide = [(p["filepath"], p["num_threads"]) for p in pools
            if p["user_api"] in ("blas", "openmp") and p["num_threads"] != 1]
    assert wide == []
