"""Whole runs of the cell ``zt_n30_apply.poles.sin_decay`` (the entry
``zt_poles``): on the CPU at n = 10, sound and with the timed path broken
underneath (``correct`` must come out false); the per-layer metrics the
cell lists, read from a traced run, and left out where the program has no
operator counters; and, on the card, the control (the program in TF32, K1
by its plain version) failing the check at the cell's own size while the
program passes.

Run from the repository root: python -m pytest portbench/tests -q
(the card's test: -m gpu on a machine with a card).
"""

from __future__ import annotations

import json
import shutil
import sys
import time
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import core, spec  # noqa: E402

CELL = "zt_n30_apply.poles.sin_decay"
# the cell at a size a CPU test run holds: n = 10, chi 64, 8 x 8 grids
SMALL = {CELL: ({"n": 10, "chi": 64},
                {"pool": 2, "coarse_points": 8, "fine_points": 8,
                 "superfine_half": 2, "check_share": 1.0})}
PER_LAYER = {"encode_ms.zt_apply", "apply_ms.zt_apply",
             "k2_roofline.zt_apply", "k2_launches_per_search.zt_apply",
             "operator_loads_per_search.zt_apply", "device_idle_pct.zt_apply",
             "k1_roofline.zt_apply", "device_ms_per_request.zt_apply"}


def small_bench(tmp: Path, cell: str = CELL):
    """BENCHMARK.json's bench with ``cell``'s configuration and mix cut to
    SMALL, the harness's entries and metrics copied under ``tmp``."""
    for d in ("entries", "metrics"):
        shutil.copytree(spec.PORTBENCH / d, tmp / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    entry = spec.find_cell(bench, cell)
    cfg_over, mix_over = SMALL[cell]
    mix = dict(spec.load_traffic(entry["traffic"]), **mix_over)
    (tmp / "traffic").mkdir()
    (tmp / "traffic" / f"{entry['traffic']}.json").write_text(json.dumps(mix))
    cfg = dict(spec.load_config(bench, entry["config"]), **cfg_over)
    (tmp / "config.json").write_text(json.dumps(cfg))
    for c in bench["configs"]:
        if c["name"] == entry["config"]:
            c["file"] = str(tmp / "config.json")
    return bench


def run(bench, tmp, *, seed=2**31 + 23, trace=False):
    return core.run_cell(bench, CELL, seed=seed, seconds=0.3, trace=trace,
                         device="cpu", t_start=time.perf_counter(), root=tmp,
                         cache_dir=tmp / "cache")


def answer_altered(monkeypatch):
    """The product state's readout returns its largest value negated."""
    from qilaplace_tpu_torch.scan import pole_scan

    chi_grid = pole_scan.chi_grid

    def broken(*args, **kw):
        out = chi_grid(*args, **kw).clone()
        flat = out.reshape(-1)
        flat[flat.abs().argmax()] *= -1
        return out

    monkeypatch.setattr(pole_scan, "chi_grid", broken)


def half_the_points_left_out(monkeypatch):
    """The product state's readout reads the first half of its grid
    configurations and gives the rest the mean of those values."""
    from qilaplace_tpu_torch.scan import pole_scan

    read = pole_scan.coefficient_batch

    def broken(state, configs):
        h = configs.shape[0] // 2
        got = read(state, configs[:h])
        return torch.cat([got, got.mean(0).expand(configs.shape[0] - h)])

    monkeypatch.setattr(pole_scan, "coefficient_batch", broken)


def peak_one_step_off(monkeypatch):
    """Every scan reports the grid point one step along l from its peak."""
    from qilaplace_tpu_torch.scan import pole_scan

    peak = pole_scan._peak

    def broken(chi, ks, ls, *args):
        res = peak(chi, ks, ls, *args)
        j = int((ls == res.l_peak).nonzero()[0])
        res.l_peak = ls[j + 1 if j + 1 < ls.shape[0] else j - 1]
        return res

    monkeypatch.setattr(pole_scan, "_peak", broken)


class NoCard:
    """The device trace needs a card; this run has none."""

    def __init__(self, device):
        self.events = []

    def start(self):
        pass

    def stop(self):
        pass


def test_a_sound_run_is_correct(tmp_path):
    out = run(small_bench(tmp_path), tmp_path)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == {"zt_err_rel_peak", "superfine_peak_steps"}
    assert list(out)[-1] == "checks"
    points = out["metrics"]["zt_points_per_s"]["value"]
    assert points > 0


@pytest.mark.parametrize("fault", [answer_altered, half_the_points_left_out,
                                   peak_one_step_off])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    bench = small_bench(tmp_path)
    fault(monkeypatch)
    out = run(bench, tmp_path)
    assert out["failed"] == 0  # the comparison catches it, not a crash
    assert not out["correct"], out["checks"]


def test_a_peak_one_step_off_fails_only_the_peak_check(tmp_path,
                                                      monkeypatch):
    bench = small_bench(tmp_path)
    peak_one_step_off(monkeypatch)
    checks = run(bench, tmp_path)["checks"]
    assert checks["superfine_peak_steps"] == {"value": 1.0, "limit": 0}
    err = checks["zt_err_rel_peak"]
    assert err["value"] <= err["limit"]


def test_the_cell_reads_its_metrics(tmp_path, monkeypatch):
    bench = small_bench(tmp_path)
    listed = {m["name"] for m in spec.metrics_for(bench, CELL, trace=True)}
    assert listed == PER_LAYER
    assert {m["name"] for m in spec.metrics_for(bench, CELL, trace=False)} \
        == {"zt_points_per_s", "setup_s"}
    monkeypatch.setattr(core, "DeviceTrace", NoCard)
    out = run(bench, tmp_path, trace=True)
    got = {k: v["value"] for k, v in out["metrics"].items()}
    # the device-trace metrics need a card's events
    assert set(got) == {"encode_ms.zt_apply", "apply_ms.zt_apply",
                        "k2_launches_per_search.zt_apply",
                        "operator_loads_per_search.zt_apply"}
    assert got["encode_ms.zt_apply"] > 0 and got["apply_ms.zt_apply"] > 0
    assert got["operator_loads_per_search.zt_apply"] == 0
    assert got["k2_launches_per_search.zt_apply"] == 0  # no K2 on a CPU
    # the warm-up's encode, in the set-up, is left out
    read = spec.load_metric("encode_ms.zt_apply")
    rec = core.Record({}, {}, {}, 1.0, [core.Request(5.0, 6.0, 1.0, True)],
                      (5.0, 6.0), [("encode", 0.0, 4.0),
                                   ("encode", 5.0, 5.5)], [], {})
    assert read(rec) == pytest.approx(500.0)


def test_a_program_without_operator_counters_leaves_the_metric_out(
        monkeypatch):
    from qilaplace_tpu_torch.transforms import zt

    entry = spec.load_entry("zt_poles")
    monkeypatch.setattr(zt, "zt_mpo", lambda *args, **kw: None)
    counters = entry.Entry.counters(types.SimpleNamespace(k1_calls=[]))
    assert "k2_launches" in counters and "operator_loads" not in counters
    rec = core.Record({}, {}, {}, 1.0, [core.Request(0.0, 1.0, 10.0, True)],
                      (0.0, 1.0), [], [], counters)
    read = spec.load_metric("operator_loads_per_search.zt_apply")
    assert read(rec) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_the_control_fails_where_the_program_passes(card):
    """At the cell's own size, a 3-second window each: the program's run
    passes its check and the control's (TF32, K1 by its plain version)
    fails it."""
    from portbench import control
    from portbench.harness.trace import patched

    bench = spec.load_benchmark()
    readings = {}
    for precision in ("float32", "tf32"):
        control.set_precision(precision)
        with patched(control.control_patches() if precision == "tf32"
                     else {}):
            out = core.run_cell(bench, CELL, seed=2**31 + 99, seconds=3,
                                trace=False, device=card,
                                t_start=time.perf_counter())
        readings[precision] = out
    control.set_precision("float32")
    assert readings["float32"]["correct"], readings["float32"]["checks"]
    assert not readings["tf32"]["correct"], readings["tf32"]["checks"]
