"""Kernel K2: batched Hermitian Jacobi eigensolver, hand-written for Hopper.

Counterpart of ``jacobi_eigh_pallas`` in ``qilaplace_tpu/ops/jacobi.py``.
The CUDA C++ source is ``qilaplace_tpu_torch/csrc/jacobi_eigh.cu``; its
header says what bounds the kernel on the card and how the design answers
that.

:func:`jacobi_eigh_k2` is the wrapper. A matrix on the CPU goes to the plain
torch version (:func:`jacobi_eigh_k2_reference`, the solver of
ops/jacobi.py with the same sweeps); a matrix on a CUDA device goes to the
kernel, built with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` (ops/kernel_build.py) and bound through ``ctypes``.
Anything the kernel does not take raises; nothing falls back. Importing
this module builds nothing.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from qilaplace_tpu_torch.ops.jacobi import default_sweeps, jacobi_eigh
from qilaplace_tpu_torch.ops.kernel_build import load_kernel

SOURCE = "jacobi_eigh.cu"
MAX_M = 512       # must match MAX_M in the CUDA source
SMEM_MAX_M = 120  # must match SMEM_MAX_M: larger m keeps G, V in device memory


def jacobi_eigh_k2_reference(H: torch.Tensor, *, sweeps: int | None = None):
    """Plain torch version of K2: :func:`~qilaplace_tpu_torch.ops.jacobi.
    jacobi_eigh` with ``sweeps`` (default ``default_sweeps(m)``). The CPU
    route of the wrapper, and what the card's kernel is checked against."""
    if sweeps is None:
        sweeps = default_sweeps(H.shape[-1])
    return jacobi_eigh(H, sweeps=sweeps)


def tolerance(m: int) -> float:
    """Bar for K2 against its references on an m x m solve (relative to
    max |lam| for eigenvalues and residuals, absolute for V^H V - I):
    1e-5, and 5e-5 from m = 256, where thousands of float32 rotations
    accumulate into V. A check that the plain float32 version itself fails
    at this bar on the same input (V^H V - I from m = 80 at 6 sweeps, say)
    holds the kernel to :func:`rounding_bar` instead."""
    return 5e-5 if m >= 256 else 1e-5


def rounding_bar(m: int, plain: float) -> float:
    """Bar for a K2 figure whose plain-version counterpart on the same
    input is ``plain``: :func:`tolerance`, or twice the plain version's
    own figure where that is larger. Both run the same rotations in
    float32, so the kernel may share the plain version's rounding floor
    (or its unconverged residual after few sweeps), not exceed it."""
    return max(tolerance(m), 2.0 * plain)


def figures(H: torch.Tensor, lam: torch.Tensor, V: torch.Tensor) -> dict:
    """The figures :func:`rounding_bar` applies to, for ``(lam, V)`` of
    ``H``: ``unit`` ||V^H V - I||_max, ``res`` ||H V - V diag(lam)||_max /
    ||H||_max, and ``eigh64`` max |lam - eigh(H in float64)| / max |lam|."""
    m = H.shape[-1]
    eye = torch.eye(m, dtype=V.dtype, device=V.device)
    H64, V64 = H.to(torch.complex128), V.to(torch.complex128)
    lam64 = lam.to(torch.float64)
    res = (H64 @ V64 - V64 * lam64[..., None, :]).abs().max()
    ref = torch.linalg.eigh(H64)[0]
    scale = float(ref.abs().max().clamp_min(1e-30))
    return {"unit": float((V.mH @ V - eye).abs().max()),
            "res": float(res) / float(H64.abs().max()),
            "eigh64": float((lam64 - ref).abs().max()) / scale}


def _kernel():
    fn = load_kernel(SOURCE).qlt_jacobi_eigh
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def jacobi_eigh_k2(H: torch.Tensor, *, sweeps: int | None = None):
    """K2: ``(lam [..., m] ascending, V [..., m, m])`` of Hermitian ``H``
    ([m, m] or [B, m, m]) after ``sweeps`` Jacobi sweeps (default
    ``default_sweeps(m)``).

    CPU matrix: the plain torch version, any dtype and m. CUDA matrix: the
    kernel, which takes float32 or complex64 with m even, 2 <= m <= 512;
    it returns float32 eigenvalues and V of the input's dtype (real for a
    real input). Every launch adds one to ``jacobi_eigh_k2.launches`` and
    to ``jacobi_eigh_k2.by_shape[(m, B, "c64" or "f32", sweeps)]``."""
    if H.device.type == "cpu":
        return jacobi_eigh_k2_reference(H, sweeps=sweeps)
    if H.device.type != "cuda":
        raise ValueError(f"K2: unsupported device {H.device}")
    if H.dtype not in (torch.float32, torch.complex64):
        raise TypeError(f"K2: dtype {H.dtype}; takes float32 or complex64")
    if H.dim() not in (2, 3) or H.shape[-1] != H.shape[-2]:
        raise ValueError(f"K2: needs [m, m] or [B, m, m], got {tuple(H.shape)}")
    m = H.shape[-1]
    if m % 2 or not 2 <= m <= MAX_M:
        raise ValueError(f"K2: m must be even and in [2, {MAX_M}], got {m}")
    if sweeps is None:
        sweeps = default_sweeps(m)
    if sweeps < 0:
        raise ValueError("K2: sweeps must be >= 0")
    squeeze = H.dim() == 2
    Hc = H.reshape(-1, m, m).to(torch.complex64).contiguous()
    B = Hc.shape[0]
    lam = torch.empty(B, m, dtype=torch.float32, device=H.device)
    V = torch.empty(B, m, m, dtype=torch.complex64, device=H.device)
    if B:
        work = ((torch.empty_like(Hc), torch.empty_like(Hc))
                if m > SMEM_MAX_M else (None, None))
        fn = _kernel()
        with torch.cuda.device(H.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(Hc.data_ptr(), lam.data_ptr(), V.data_ptr(),
                     *(0 if w is None else w.data_ptr() for w in work),
                     B, m, sweeps, stream)
        if err != 0:
            raise RuntimeError(f"K2 launch failed: CUDA error {err}")
        jacobi_eigh_k2.launches += 1
        kind = "c64" if H.is_complex() else "f32"
        jacobi_eigh_k2.by_shape[(m, B, kind, sweeps)] += 1
    if not H.is_complex():
        V = V.real.contiguous()
    if squeeze:
        return lam[0], V[0]
    return lam, V


jacobi_eigh_k2.launches = 0
jacobi_eigh_k2.by_shape = collections.Counter()
