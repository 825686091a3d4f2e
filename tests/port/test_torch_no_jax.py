"""The port imports no JAX and builds nothing at import time; its
``parallel`` package and ``entry`` module have the JAX package's names, and
its ``tutorials`` package (scanned with every other module) runs no
tutorial on import."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PORT_FILES = sorted(Path(REPO, "qilaplace_tpu_torch").rglob("*.py"))

CODE = """
import importlib
import pkgutil
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import qilaplace_tpu_torch
import qilaplace_tpu_torch.ops.kernel_build as kb
for mod in pkgutil.walk_packages(qilaplace_tpu_torch.__path__,
                                 "qilaplace_tpu_torch."):
    importlib.import_module(mod.name)
assert not any(m == "jax" or m.startswith(("jax.", "qilaplace_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
assert not kb._LOADED  # nothing compiled on import
# the counterparts of qilaplace_tpu.parallel and of __graft_entry__.py
import qilaplace_tpu_torch.entry as entry
import qilaplace_tpu_torch.parallel as parallel
assert parallel.__all__ == [
    "make_mesh", "shard_batch", "replicate", "batched_signal_mps",
    "batched_qft_pipeline", "sharded_chi_grid", "stack_mpos",
    "multi_mpo_chi_batch", "sharded_multi_scan", "fit_mpo_step"]
assert all(callable(getattr(parallel, name)) for name in parallel.__all__)
assert callable(entry.entry) and callable(entry.dryrun_multichip)
# the tutorials: each exposes inputs() and run(); importing one runs nothing
for name in ("signal", "dft", "dt", "zt"):
    mod = importlib.import_module("qilaplace_tpu_torch.tutorials." + name)
    assert callable(mod.inputs) and callable(mod.run)
print("IMPORT_OK")
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PATH=os.pathsep.join(
        p for p in os.environ.get("PATH", "").split(os.pathsep)
        if not os.path.exists(os.path.join(p, "nvcc"))
    ))
    proc = subprocess.run([sys.executable, "-c", CODE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == "IMPORT_OK\n"  # no module printed on import


# what runs on the card's machine, which has no JAX: the smoke run, the
# GPU test modules and the kernel-variant scripts
CARD_FILES = [Path(REPO, "chip_smoke.py"),
              Path(REPO, "tests", "port", "port_helpers.py"),
              Path(REPO, "tests", "port", "test_torch_readout_routes.py"),
              *sorted(Path(REPO, "tests", "port").glob("test_torch_*_gpu.py")),
              *sorted(Path(REPO, "scripts", "port").glob("k*_variants.py"))]


@pytest.mark.parametrize(
    "path", PORT_FILES + CARD_FILES, ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_anywhere_in_the_source(path):
    """Also the imports inside functions, which importing never runs."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "qilaplace_tpu"), (
                f"{path}: imports {name}")
