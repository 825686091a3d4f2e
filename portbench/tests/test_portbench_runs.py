"""Whole runs of the benchmark's cells, the look for a card skipped: on the
CPU at a size a test run holds, sound and with the timed path broken
underneath (``correct`` must come out false); a metric file added beside
the others is read without editing any file; and, on the card, each cell's
control (the program in TF32, K1 by its plain version) fails its check at
the cell's own size while the program passes.

Run from the repository root: python -m pytest portbench/tests -q
(the card's test: -m gpu on a machine with a card).
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import core, spec  # noqa: E402

# the cells at a size a CPU test run holds: n = 10, 8 x 8 grids, chi 16
SEARCH = {"pool": 2, "coarse_points": 8, "fine_points": 8,
          "superfine_half": 2, "check_share": 1.0}
SMALL = {
    "zt_n30.grid.sin_decay": ({"n": 10}, SEARCH),
    "zt_n30.grid.multi_sin_exp": ({"n": 10}, SEARCH),
    "qft_n28.spectrum": ({"n": 10, "chi": 16}, {"frequencies": 64}),
}


def small_bench(tmp: Path, cell: str):
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


def run(bench, cell, tmp, *, seed=2**31 + 17, trace=False):
    return core.run_cell(bench, cell, seed=seed, seconds=0.3, trace=trace,
                         device="cpu", t_start=time.perf_counter(), root=tmp,
                         cache_dir=tmp / "cache")


def negate_largest(fn):
    """``fn`` with the largest value of its answer negated."""
    def broken(*args, **kw):
        out = fn(*args, **kw).clone()
        flat = out.reshape(-1)
        flat[flat.abs().argmax()] *= -1
        return out
    return broken


def answer_altered(monkeypatch, cell):
    """An answer altered where it is produced: the readout of each cell's
    entry point returns its largest value negated."""
    if cell.startswith("zt_"):
        from qilaplace_tpu_torch.scan import pole_scan

        monkeypatch.setattr(pole_scan, "direct_vals",
                            negate_largest(pole_scan.direct_vals))
    else:
        from qilaplace_tpu_torch.models.pipelines import QFTPipeline

        monkeypatch.setattr(QFTPipeline, "spectrum",
                            negate_largest(QFTPipeline.spectrum))


def first_half(fn):
    """``fn(a, b, rows)`` computed on the first half of ``rows`` only, the
    rest given the mean of those values."""
    def broken(a, b, rows):
        h = rows.shape[0] // 2
        got = fn(a, b, rows[:h])
        return torch.cat([got, got.mean(0).expand(rows.shape[0] - h)])
    return broken


def half_batch_left_out(monkeypatch, cell):
    """Half of the batch left out: the readout of each cell's entry point
    reads the first half of its points (grid configurations, frequencies)
    and gives the rest the mean of those values."""
    if cell.startswith("zt_"):
        from qilaplace_tpu_torch.scan import pole_scan

        monkeypatch.setattr(pole_scan, "direct_vals",
                            first_half(pole_scan.direct_vals))
    else:
        from qilaplace_tpu_torch.models.pipelines import QFTPipeline

        monkeypatch.setattr(QFTPipeline, "spectrum",
                            first_half(QFTPipeline.spectrum))


FAULTS = [(cell, fault) for cell in SMALL
          for fault in (answer_altered, half_batch_left_out)]


@pytest.mark.parametrize("cell", list(SMALL))
def test_a_sound_run_is_correct(tmp_path, cell):
    out = run(small_bench(tmp_path, cell), cell, tmp_path)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert out["device"]["platform"] == "cpu"
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell, fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell,
                                            fault):
    bench = small_bench(tmp_path, cell)
    fault(monkeypatch, cell)
    out = run(bench, cell, tmp_path)
    assert out["failed"] == 0  # the comparison catches it, not a crash
    assert not out["correct"], out["checks"]


def test_a_new_metric_file_is_read_without_editing_a_file(tmp_path,
                                                          monkeypatch):
    cell = "qft_n28.spectrum"
    bench = small_bench(tmp_path, cell)
    (tmp_path / "metrics" / "requests_seen.qft.py").write_text(
        "def read(rec):\n    return float(len(rec.requests))\n")
    bench["per_layer"].append({
        "name": "requests_seen.qft", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "entry", "moves": "spectra_per_s",
        "workloads": [cell]})

    class NoCard:  # the device trace needs a card; this run has none
        def __init__(self, device):
            self.events = []

        def start(self):
            pass

        def stop(self):
            pass

    monkeypatch.setattr(core, "DeviceTrace", NoCard)
    out = run(bench, cell, tmp_path, trace=True)
    assert out["metrics"]["requests_seen.qft"]["value"] == out["attempted"]
    assert "breakdown" in out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(SMALL))
def test_the_control_fails_where_the_program_passes(card, cell):
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
            out = core.run_cell(bench, cell, seed=2**31 + 99, seconds=3,
                                trace=False, device=card,
                                t_start=time.perf_counter())
        readings[precision] = out
    control.set_precision("float32")
    assert readings["float32"]["correct"], readings["float32"]["checks"]
    assert not readings["tf32"]["correct"], readings["tf32"]["checks"]
