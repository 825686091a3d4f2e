"""CPU tests of the benchmark's harness: the window's arithmetic, the frozen
operation counts, the lookup of configurations, mixes, entries and metrics
by name, and the whole-name check of loaded modules.

Run from the repository root: python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import core, spec, trace, yardstick  # noqa: E402


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        return self.now


class TimedEntry:
    """An entry whose i-th request takes ``durations[i]`` seconds of a fake
    clock and does ``units`` of work."""

    def __init__(self, clock, durations, units=10.0):
        self.clock, self.durations, self.units = clock, durations, units

    def prepare(self, i):
        pass

    def request(self, i):
        self.clock.now += self.durations[i]
        return self.units


def run_window(monkeypatch, durations, seconds):
    clock = FakeClock()
    monkeypatch.setattr(core, "time", types.SimpleNamespace(
        perf_counter=clock.perf_counter))
    ctx = types.SimpleNamespace(device=torch.device("cpu"), sync=lambda: None,
                                spans=None)
    reqs, events, counters = core._window(TimedEntry(clock, durations), ctx,
                                          seconds, trace=False)
    return reqs


def record(reqs):
    return core.Record({}, {}, {}, 1.5, reqs, (reqs[0].t0, reqs[-1].t1),
                       [], [], {})


def test_window_keeps_the_request_that_ends_after_the_limit(monkeypatch):
    # requests start at 0, 4, 8, 12 (< 13 s) and the last ends at 20
    reqs = run_window(monkeypatch, [4, 4, 4, 8, 1, 1], seconds=13)
    assert len(reqs) == 4
    assert (reqs[0].t0, reqs[-1].t1) == (100.0, 120.0)
    rec = record(reqs)
    assert rec.window_s == 20.0
    rate = spec.load_metric("zt_points_per_s")(rec)
    assert rate == pytest.approx(40.0 / 20.0)


def test_p95_is_over_every_request(monkeypatch):
    durations = [0.01] * 95 + [1.0] * 5
    reqs = run_window(monkeypatch, durations, seconds=5.9)
    assert len(reqs) == 100
    p95 = spec.load_metric("zt_grid_p95_ms")(record(reqs))
    want = 1e3 * __import__("statistics").quantiles(
        durations, n=100, method="inclusive")[94]
    assert p95 == pytest.approx(want)
    assert 10.0 < p95 < 1000.0


def test_failed_requests_count_and_do_no_work(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(core, "time", types.SimpleNamespace(
        perf_counter=clock.perf_counter))

    class Failing(TimedEntry):
        def request(self, i):
            super().request(i)
            if i == 1:
                raise RuntimeError("planted")
            return self.units

    ctx = types.SimpleNamespace(device=torch.device("cpu"), sync=lambda: None,
                                spans=None)
    reqs, _, _ = core._window(Failing(clock, [1, 1, 1]), ctx, 2.5, False)
    assert [r.ok for r in reqs] == [True, False, True]
    assert spec.load_metric("spectra_per_s")(record(reqs)) == \
        pytest.approx(20.0 / 3.0)


def test_k1_counts_at_a_hand_counted_shape():
    # two rows, two sites, bonds of width 1, 2, 1: 1*2 + 2*1 = 4 live entries
    ops, nbytes = yardstick.k1_counts(2, 2, [1, 2, 1])
    assert ops == 8 * 2 * 4
    assert nbytes == 2 * 4 * 8 + 2 * 2 * 4 + 2 * 8


def test_k2_counts_at_a_hand_counted_shape():
    # m = 4, one sweep = 3 rounds of 30 m^2 complex flops
    assert yardstick.k2_counts(4, 1, "c64", 1) == (3 * 30 * 16,
                                                   16 * 8 + 16 + 16 * 8)
    assert yardstick.k2_counts(4, 2, "f32", 2) == (2 * 6 * 9 * 16,
                                                   2 * (16 * 4 + 16 + 16 * 4))


def test_live_widths_match_the_kernels_pre_pass():
    from qilaplace_tpu_torch.ops.readout_kernels import pack_live_lanes

    gen = torch.Generator().manual_seed(3)
    cores = torch.randn(5, 8, 2, 8, dtype=torch.complex64, generator=gen)
    cores[:, 5:] = 0  # dead rows
    cores[1, :, :, 2] = 0  # a dead column inside a bond
    cores[0, 1:] = 0
    cores[-1, :, :, 1:] = 0
    widths = yardstick.live_widths(cores)
    assert widths.tolist() == pack_live_lanes(cores)[1].tolist()


def test_bound_takes_the_larger_of_operations_and_bytes():
    assert yardstick.bound_s(67e12, 0) == pytest.approx(1.0)
    assert yardstick.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_busy_seconds_is_the_union_clipped_to_the_window():
    events = [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 5.0, 7.0)]
    assert yardstick.busy_seconds(events, 0.5, 6.0) == pytest.approx(3.5)


def test_breakdown_names_idle_time_by_the_spans_over_it():
    events = [("k", 1.0, 2.0), ("k", 3.0, 4.0)]
    spans = [("request", 0.0, 5.0), ("encode", 2.0, 3.0)]
    out = trace.breakdown(events, spans, 0.0, 5.0)
    assert out["device_ops"] == [["k", 2.0]]
    assert dict(map(tuple, out["idle_gaps"])) == {
        "request": 2.0, "request / encode": 1.0}


def test_every_name_in_the_benchmark_has_its_file():
    bench = spec.load_benchmark()
    for cfg in bench["configs"]:
        assert spec.load_config(bench, cfg["name"])["name"] == cfg["name"]
    for cell in bench["workloads"]:
        mix = spec.load_traffic(cell["traffic"])
        assert hasattr(spec.load_entry(mix["entry"]), "Entry")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_metric(m["name"]))


@pytest.mark.parametrize("cell, e2e, layers", [
    ("zt_n30.grid.sin_decay",
     {"zt_points_per_s", "zt_grid_p95_ms", "setup_s"},
     {"k1_roofline.zt", "device_ms_per_request.zt", "device_idle_pct.zt"}),
    ("zt_n30.grid.multi_sin_exp", {"zt_points_per_s", "setup_s"},
     {"device_ms_per_request.zt", "device_idle_pct.zt"}),
    ("qft_n28.spectrum", {"spectra_per_s", "setup_s"},
     {"encode_ms.qft", "apply_ms.qft", "k2_roofline.qft",
      "k2_launches_per_signal.qft", "device_idle_pct.qft"}),
])
def test_metrics_are_found_by_cell(cell, e2e, layers):
    bench = spec.load_benchmark()
    assert {m["name"] for m in spec.metrics_for(bench, cell, False)} == e2e
    assert {m["name"] for m in spec.metrics_for(bench, cell, True)} == layers


def test_a_split_without_a_file_of_its_own_is_read_by_its_base(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "seen.py").write_text(
        "def read(rec):\n    return 1.0\n")
    (tmp_path / "metrics" / "seen.b.py").write_text(
        "def read(rec):\n    return 2.0\n")
    assert spec.load_metric("seen.a", tmp_path)(None) == 1.0
    assert spec.load_metric("seen.b", tmp_path)(None) == 2.0
    with pytest.raises(FileNotFoundError):
        spec.load_metric("unseen.a", tmp_path)


def test_a_metric_without_workloads_follows_what_it_moves():
    bench = {"end_to_end": [{"name": "x", "workloads": ["a"]},
                            {"name": "setup_s"}],
             "per_layer": [{"name": "y", "moves": "x"},
                           {"name": "z", "moves": "setup_s"}]}
    assert [m["name"] for m in spec.metrics_for(bench, "a", True)] == ["y",
                                                                       "z"]
    assert [m["name"] for m in spec.metrics_for(bench, "b", True)] == ["z"]


def test_a_name_that_is_no_benchmark_name_is_refused():
    with pytest.raises(ValueError):
        spec.load_traffic("../BENCHMARK")


@pytest.mark.parametrize("name, flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax", True), ("qilaplace_tpu", True), ("qilaplace_tpu.ops", True),
    ("qilaplace_tpu_torch", False), ("qilaplace_tpu_torch.ops.apply", False),
    ("jaxtyping", False), ("flaxen", False),
])
def test_forbidden_modules_compare_whole_top_level_names(monkeypatch, name,
                                                         flagged):
    for mod in list(sys.modules):
        if mod.split(".")[0] in core.FORBIDDEN:
            monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in core.forbidden_modules()) is flagged


def test_run_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the command would run the cell")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "zt_n30.grid.sin_decay", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_run_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "zt_n30.grid.sin_decay", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "qilaplace_tpu_torch" in out.stderr


def test_benchmark_json_keeps_to_its_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in bench[key]]
    assert len(names) == len(set(names))
    assert all(spec.NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert set(m["workloads"]) <= {c["name"] for c in bench["workloads"]}
