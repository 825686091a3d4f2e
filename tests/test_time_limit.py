"""The per-phase time limit of the root ``conftest.py``, run as it runs in
tier-1 (pytest-xdist, ``--dist loadfile``) in a pytest of its own, with the
limits cut to 1 s and 4 s: a test that stalls in Python fails with its node
id and phase; one that hangs inside a C call is dumped, its worker
replaced and the test failed, not run again, in the new worker; the tests
after both still run, and no alarm is left armed between phases."""

import os
import pathlib
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest

ROOT_CONFTEST = pathlib.Path(__file__).parents[1] / "conftest.py"

CONFTEST = """
import importlib.util
import signal

spec = importlib.util.spec_from_file_location("limits", {path!r})
limits = importlib.util.module_from_spec(spec)
spec.loader.exec_module(limits)
limits.TEST_LIMIT_S, limits.HARD_LIMIT_S = 1, 4
pytest_configure = limits.pytest_configure
pytest_unconfigure = limits.pytest_unconfigure
pytest_runtest_setup = limits.pytest_runtest_setup
pytest_runtest_call = limits.pytest_runtest_call
pytest_runtest_teardown = limits.pytest_runtest_teardown

HANDLER = signal.getsignal(signal.SIGALRM)


def pytest_runtest_logreport(report):
    # runs after each phase, outside the limit
    if (signal.getitimer(signal.ITIMER_REAL)[0]
            or signal.getsignal(signal.SIGALRM) is not HANDLER):
        with open("left_armed.txt", "a") as f:
            f.write(f"{{report.nodeid}} {{report.when}}\\n")
"""

TESTS = """
import signal
import time

import pytest


def test_stalls_in_its_call():
    time.sleep(30)


@pytest.fixture
def stalled():
    time.sleep(30)


def test_stalls_in_its_setup(stalled):
    pass


def test_runs_under_a_fresh_limit():
    assert 0.9 < signal.getitimer(signal.ITIMER_REAL)[0] <= 1


def test_hangs_inside_one_c_call():
    # the main thread takes no SIGALRM, as in a long C call
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(30)


def test_runs_after_the_crash():
    pass
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    where = tmp_path_factory.mktemp("time_limit")
    (where / "conftest.py").write_text(CONFTEST.format(path=str(ROOT_CONFTEST)))
    (where / "test_stalls.py").write_text(TESTS)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_") and k != "TEST_RUNNING_DIR"}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "test_stalls.py", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "xdist",
         "-n", "1", "--dist", "loadfile", "--junitxml=out.xml"],
        cwd=where, env=env, capture_output=True, text=True, timeout=120)
    cases = {}
    for case in ET.parse(where / "out.xml").iter("testcase"):
        bad = case.find("failure")
        if bad is None:
            bad = case.find("error")
        cases.setdefault(case.get("name"), []).append(
            None if bad is None else (bad.tag, bad.get("message")))
    return proc, cases, where


def test_a_stall_in_the_call_fails_with_its_node_id_and_phase(run):
    _, cases, _ = run
    [(tag, message)] = cases["test_stalls_in_its_call"]
    assert tag == "failure"
    assert ("test_stalls.py::test_stalls_in_its_call (call) passed the 1 s "
            "limit") in message


def test_a_stall_in_a_fixture_errors_in_setup(run):
    _, cases, _ = run
    [(tag, message)] = cases["test_stalls_in_its_setup"]
    assert tag == "error"
    assert ("test_stalls.py::test_stalls_in_its_setup (setup) passed the 1 s "
            "limit") in message


def test_a_hang_in_c_is_dumped_and_its_worker_replaced(run):
    proc, cases, _ = run
    [crashed, again] = cases["test_hangs_inside_one_c_call"]
    assert crashed == ("error", "failed on setup with \"worker 'gw0' crashed "
                       "while running 'test_stalls.py::"
                       "test_hangs_inside_one_c_call'\"")
    assert again[0] == "error"
    assert ("test_stalls.py::test_hangs_inside_one_c_call (setup): an earlier "
            "worker hung in this test past the 4 s limit") in again[1]
    out = proc.stderr + proc.stdout
    assert "Timeout (0:00:04)!" in out
    assert "in test_hangs_inside_one_c_call" in out
    assert cases["test_runs_after_the_crash"] == [None]


def test_the_alarm_is_cleared_between_phases(run):
    _, cases, where = run
    assert cases["test_runs_under_a_fresh_limit"] == [None]
    assert not (where / "left_armed.txt").exists()
