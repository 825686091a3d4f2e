"""One BLAS and OpenMP thread in every pool of a test process.

The host code factorizes many small matrices, where a multi-threaded BLAS
only adds overhead, and each of pytest-xdist's workers would start pools as
wide as the machine: OpenBLAS then spins on oversubscribed cores. The root
``conftest.py`` applies this at import for every test, and
``tests/port/conftest.py`` applies it for the port tests run alone
(``--confcutdir=tests/port``, as on the card)."""

import importlib.util
import os


def one_thread_per_pool():
    """Set the thread variables, which processes started later (the xdist
    workers) read before their numpy loads, and limit the pools already
    loaded in this process (through ``threadpoolctl``, where installed)."""
    for var in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    if importlib.util.find_spec("threadpoolctl") is not None:
        from threadpoolctl import threadpool_limits

        threadpool_limits(limits=1)
