"""Build and load the port's hand-written CUDA kernels.

Every kernel source under ``qilaplace_tpu_torch/csrc/`` has a plain C
interface. At first use it is compiled with ``nvcc`` for ``sm_90a`` into a
shared library under ``build/kernels/`` at the repository root, named by a
hash of the source, and loaded with ``ctypes``; a library whose source is
unchanged is reused. :func:`build_kernels` starts one ``nvcc`` per source,
all at once, and waits for them together. Importing this module builds
nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

_LOADED: dict[str, tuple[ctypes.CDLL, dict]] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("kernel build: no CUDA toolkit found (CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{digest}.so"


def build_kernels(*names: str) -> dict[str, dict]:
    """Compile (where not built yet) and load the kernels ``names`` (file
    names under ``csrc/``), with one ``nvcc`` process per source running
    in parallel. Returns, per name, the library's path, whether it was
    reused, the build's wall seconds and the compiler log (``-Xptxas -v``:
    registers, shared memory and spills per kernel). Raises if any build
    fails."""
    todo = [nm for nm in names if nm not in _LOADED]
    procs = {}
    for nm in todo:
        source = CSRC / nm
        lib_path = _lib_path(source)
        info = {"path": str(lib_path), "cached": lib_path.exists(),
                "seconds": 0.0, "log": ""}
        if info["cached"]:
            procs[nm] = (None, None, info, time.perf_counter())
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs[nm] = (proc, tmp, info, time.perf_counter())
    failed = []
    for nm, (proc, tmp, info, t0) in procs.items():
        if proc is not None:
            info["log"] = proc.communicate()[0]
            info["seconds"] = time.perf_counter() - t0
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"{nm}:\n{info['log']}")
                continue
            os.replace(tmp, info["path"])
        _LOADED[nm] = (ctypes.CDLL(info["path"]), info)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {nm: _LOADED[nm][1] for nm in names}


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, built at first use."""
    if name not in _LOADED:
        build_kernels(name)
    return _LOADED[name][0]
