"""Find a cell's configuration, traffic mix, entry and metric readers by name.

Everything that belongs to one configuration, mix or per-layer metric is a
file of its own: ``configs/<config>.json`` (named by ``BENCHMARK.json``),
``traffic/<mix>.json``, ``entries/<entry>.py`` (named by the mix) and
``metrics/<metric>.py`` (or ``metrics/<base>.py`` for the splits
``<base>.<split>`` of one quantity that share a reader). Adding one is adding a file and an entry in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent
# the program's artifact caches (the zT operators), at a fixed path in the
# checkout that git ignores
CACHE = ROOT / "build" / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_benchmark(path: Path | None = None) -> dict:
    """``BENCHMARK.json`` at the checkout's root (or ``path``)."""
    return json.loads(Path(path or ROOT / "BENCHMARK.json").read_text())


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def load_config(bench: dict, name: str) -> dict:
    """The configuration file that ``BENCHMARK.json`` names for ``name``."""
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            return json.loads((ROOT / cfg["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_traffic(name: str, root: Path = PORTBENCH) -> dict:
    """``traffic/<name>.json``: the mix's parameters and the entry it
    drives."""
    return json.loads((root / "traffic" / f"{_checked(name)}.json").read_text())


def _load_module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_{tag}_{re.sub(r'[^A-Za-z0-9_]', '_', path.stem)}", path)
    if spec is None or spec.loader is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_entry(name: str, root: Path = PORTBENCH):
    """``entries/<name>.py``: the code that drives one entry point of the
    port."""
    return _load_module(root / "entries" / f"{_checked(name)}.py", "entry")


def load_metric(name: str, root: Path = PORTBENCH):
    """``metrics/<name>.py``'s ``read(record)``: the metric's number, or
    None where the record holds nothing for it to read. A split of one
    quantity, ``<base>.<split>``, without a file of its own is read by
    ``metrics/<base>.py``."""
    path = root / "metrics" / f"{_checked(name)}.py"
    if not path.is_file() and "." in name:
        path = root / "metrics" / f"{name.split('.')[0]}.py"
    return _load_module(path, "metric").read


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` prints: with ``trace`` the per-layer
    ones, else the end-to-end ones. A metric with ``workloads`` belongs to
    the cells it lists; an end-to-end metric without it to every cell; a
    per-layer metric without it to every cell that reports the end-to-end
    metric it ``moves``."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
