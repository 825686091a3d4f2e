"""Policies for every test process of this checkout. pytest loads this file
before ``tests/conftest.py`` and before pytest-xdist starts its workers,
which inherit the environment it sets.

* One BLAS and OpenMP thread in every pool (``tests/port/thread_policy.py``).
* A time limit on each phase (setup, call, teardown) of each test. Past
  ``TEST_LIMIT_S`` a SIGALRM fails the test with its node id, its phase and
  the Python stack it stalled in. Python runs that handler only between
  bytecodes, so a stall inside one C call (BLAS, XLA, a torch op) never
  reaches it: past ``HARD_LIMIT_S`` faulthandler writes every thread's stack
  to stderr and ends the process. pytest-xdist then reports the test as
  crashed and starts a new worker, and the run goes on; a run without xdist
  ends there. Under ``--dist loadfile`` xdist queues the crashed test again
  for the new worker, so each test marks itself running in a directory all
  the run's processes share, and a test found marked fails at once."""

import faulthandler
import hashlib
import os
import pathlib
import runpy
import shutil
import signal
import tempfile

import pytest

runpy.run_path(
    str(pathlib.Path(__file__).parent / "tests" / "port" / "thread_policy.py")
)["one_thread_per_pool"]()

# Over three times the slowest test measured (test_zt_parity[8], about 85 s).
TEST_LIMIT_S = 300
HARD_LIMIT_S = 360

# made by the run's first process; the xdist workers inherit the variable
_OWNS_RUNNING = "TEST_RUNNING_DIR" not in os.environ
if _OWNS_RUNNING:
    os.environ["TEST_RUNNING_DIR"] = tempfile.mkdtemp(prefix="running-")
_RUNNING = pathlib.Path(os.environ["TEST_RUNNING_DIR"])

_stderr = pytest.StashKey[int]()


def pytest_configure(config):
    # output capture is suspended here, so fd 2 is the run's own stderr
    config.stash[_stderr] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_stderr])
    if _OWNS_RUNNING:
        shutil.rmtree(_RUNNING, ignore_errors=True)


def _limited(phase):
    @pytest.hookimpl(wrapper=True)
    def hook(item):
        what = f"{item.nodeid} ({phase})"
        running = _RUNNING / hashlib.sha1(item.nodeid.encode()).hexdigest()
        if running.exists():
            pytest.fail(f"{what}: an earlier worker hung in this test past "
                        f"the {HARD_LIMIT_S} s limit", pytrace=False)

        def stall(signum, frame):
            pytest.fail(f"{what} passed the {TEST_LIMIT_S} s limit")

        running.touch()
        previous = signal.signal(signal.SIGALRM, stall)
        signal.setitimer(signal.ITIMER_REAL, TEST_LIMIT_S)
        faulthandler.dump_traceback_later(
            HARD_LIMIT_S, exit=True, file=item.config.stash[_stderr])
        try:
            return (yield)
        finally:
            faulthandler.cancel_dump_traceback_later()
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)
            running.unlink()

    return hook


pytest_runtest_setup = _limited("setup")
pytest_runtest_call = _limited("call")
pytest_runtest_teardown = _limited("teardown")
