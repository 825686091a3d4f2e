"""Kernel K1: batched coefficient readout of a chain, hand-written for Hopper.

Counterpart of ``qilaplace_tpu/ops/pallas_kernels.py``
(``coefficient_batch_pallas``). The CUDA C++ source is
``qilaplace_tpu_torch/csrc/coefficient_batch.cu``; its header says what
bounds the kernel on the card and how the design answers that.

:func:`coefficient_batch_k1` is the wrapper. A chain on the CPU goes to the
plain torch version (:func:`coefficient_batch_k1_reference`); a chain on a
CUDA device goes to the kernel, which is compiled with ``nvcc`` for
``sm_90a`` at first use into ``build/kernels/`` (keyed by a hash of the
source) and bound through ``ctypes``. Anything the kernel does not take
raises; nothing falls back. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from qilaplace_tpu_torch.core.mps import coefficient_batch

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "coefficient_batch.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
MAX_CHI = 256  # must match MAX_CHI in the CUDA source


def coefficient_batch_k1_reference(chain, configs) -> torch.Tensor:
    """Plain torch version of K1: for each config row, v = e_0 and
    v <- v @ A[site, :, bit, :] over the sites (both branch products formed,
    each row keeps its bit's), returning ``amplitude * v[:, 0]`` in the
    chain's dtype. The CPU route of the wrapper, and what the card's kernel
    is checked against."""
    return coefficient_batch(chain, configs)


@functools.lru_cache(maxsize=1)
def _build() -> tuple[ctypes.CDLL, dict]:
    """Compile the kernel (once per source hash) and load it."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("K1 build: no CUDA toolkit found (CUDA_HOME)")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"coefficient_batch_{digest}.so"
    info = {"path": str(lib_path), "cached": lib_path.exists(),
            "seconds": 0.0, "log": ""}
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", tmp, str(_SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"K1 build failed:\n{info['log']}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.qlt_coefficient_batch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, info


def build_k1() -> dict:
    """Build (or reuse) and load the kernel; returns the build's path,
    seconds and compiler log (registers and shared memory per ``-Xptxas
    -v``)."""
    return _build()[1]


def coefficient_batch_k1(chain, configs) -> torch.Tensor:
    """K1: ``amplitude * <e_0| prod_site A[site, :, bit, :] |e_0>`` for every
    row of ``configs`` [B, n].

    CPU chain: the plain torch version, any dtype. CUDA chain: the kernel,
    which takes contiguous complex64 cores with chi <= 256, a real
    amplitude and contiguous int32 configs [B, n] on the same device; it
    returns complex64 [B]. Every launch adds one to
    ``coefficient_batch_k1.launches``."""
    m = getattr(chain, "chain", chain)
    cores = m.cores
    if cores.device.type == "cpu":
        return coefficient_batch_k1_reference(m, configs)
    if cores.device.type != "cuda":
        raise ValueError(f"K1: unsupported device {cores.device}")
    if cores.dtype != torch.complex64 or not cores.is_contiguous():
        raise TypeError("K1: cores must be contiguous complex64")
    n, chi = m.n, m.chi
    if chi > MAX_CHI:
        raise ValueError(f"K1: chi {chi} exceeds {MAX_CHI}")
    if (not isinstance(configs, torch.Tensor) or configs.dtype != torch.int32
            or configs.dim() != 2 or configs.shape[1] != n
            or configs.device != cores.device
            or not configs.is_contiguous()):
        raise TypeError(
            f"K1: configs must be a contiguous int32 [B, {n}] tensor on "
            f"{cores.device}"
        )
    if m.amplitude.is_complex():
        raise TypeError("K1: the amplitude must be real")
    amp = m.amplitude.to(device=cores.device, dtype=torch.float32).reshape(1)
    B = configs.shape[0]
    out = torch.empty(B, dtype=torch.complex64, device=cores.device)
    if B == 0:
        return out
    lib, _ = _build()
    with torch.cuda.device(cores.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qlt_coefficient_batch(
            cores.data_ptr(), configs.data_ptr(), amp.data_ptr(),
            out.data_ptr(), B, n, chi, stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    coefficient_batch_k1.launches += 1
    return out


coefficient_batch_k1.launches = 0
