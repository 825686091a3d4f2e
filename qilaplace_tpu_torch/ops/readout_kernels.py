"""Kernel K1: batched coefficient readout of a chain, hand-written for Hopper.

Counterpart of ``qilaplace_tpu/ops/pallas_kernels.py``
(``coefficient_batch_pallas``). The CUDA C++ source is
``qilaplace_tpu_torch/csrc/coefficient_batch.cu``; its header says what
bounds the kernel on the card and how the design answers that.

:func:`coefficient_batch_k1` is the wrapper. A chain on the CPU goes to the
plain torch version (:func:`coefficient_batch_k1_reference`); a chain on a
CUDA device goes to the kernel, which is compiled with ``nvcc`` for
``sm_90a`` at first use into ``build/kernels/`` (keyed by a hash of the
source; ops/kernel_build.py) and bound through ``ctypes``. Anything the
kernel does not take raises; nothing falls back. Importing this module
builds nothing.
"""

from __future__ import annotations

import ctypes

import torch

from qilaplace_tpu_torch.core.mps import coefficient_batch
from qilaplace_tpu_torch.ops.kernel_build import load_kernel

SOURCE = "coefficient_batch.cu"
MAX_CHI = 256  # must match MAX_CHI in the CUDA source


def coefficient_batch_k1_reference(chain, configs) -> torch.Tensor:
    """Plain torch version of K1: for each config row, v = e_0 and
    v <- v @ A[site, :, bit, :] over the sites (both branch products formed,
    each row keeps its bit's), returning ``amplitude * v[:, 0]`` in the
    chain's dtype. The CPU route of the wrapper, and what the card's kernel
    is checked against."""
    return coefficient_batch(chain, configs)


def _kernel():
    fn = load_kernel(SOURCE).qlt_coefficient_batch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    fn = _kernel()
    with torch.cuda.device(cores.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            cores.data_ptr(), configs.data_ptr(), amp.data_ptr(),
            out.data_ptr(), B, n, chi, stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    coefficient_batch_k1.launches += 1
    return out


coefficient_batch_k1.launches = 0
