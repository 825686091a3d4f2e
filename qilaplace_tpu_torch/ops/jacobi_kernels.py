"""Kernel K2: batched Hermitian Jacobi eigensolver, hand-written for Hopper.

Replaces the TPU kernel ``_jacobi_kernel`` (``qilaplace_tpu/ops/jacobi.py:
302``, launched by ``jacobi_eigh_pallas`` at ``:420``). The CUDA C++ source
is ``qilaplace_tpu_torch/csrc/jacobi_eigh.cu``. What bounds it on the card
is the chain of sweeps * (m - 1) dependent rounds at B = 1, so the design
cuts the latency of a round:

- pair-adjacent layout, as the plain version keeps it: pair i sits at
  positions (2i, 2i+1), and each round writes its output at the next
  round's positions (:func:`position_moves`, handed to the kernel as a
  table of m ints and cached on the device per m) in a second buffer;
- one synchronisation a round: G is double-buffered, and warps of
  rotation makers (one thread a pair) rebuild each pair's next diagonal
  block from this round's G and rotations and make the next round's
  rotations while the other threads update G;
- no division in the round: the 2-D thread index maps threads to blocks;
  up to 1,024 threads a block;
- a real variant: float32 input stays float32 (9 m^2 flops a round, half
  the memory) and V comes back real.

By m, and what bounds each variant on an H100 (PERF.md):

- up to ``SMEM_MAX_M`` (84): one block a matrix holds G and V in shared
  memory and updates both each round; a round is bound by the block's
  own latency (0.7-1.5 us: the rotation's chain, the update, a barrier);
- up to ``CLUSTER_MAX_M`` (320): G alone is split by column pairs over
  the shared memory of a cluster of up to 8 blocks; each round the blocks
  trade the next rotations and the edge columns by ``st.async`` into each
  other's shared memory, each waiting on its own mbarrier (no cluster
  barrier), and log the rotations to device memory; a pair's rotation is
  made in the block that holds the column of its next diagonal block that
  crossed an edge, if one did, so that no block reads a column in another
  before it has landed there. A round (1.7-2.8 us) is bound by that
  exchange;
- above, up to ``MAX_M`` (512): the same storage on a group of up to 32
  blocks (8 column pairs each) that the launch makes resident together
  (cooperatively; it refuses a grid the card cannot hold), exchanging
  through L2: each block also keeps the columns of the pair beside each
  edge, so every rotation is made from its own shared memory; its owners
  store the columns a neighbour keeps into that neighbour's inbox, its
  makers log the rotations, and a fenced flag a block publishes the round,
  which every block waits for before it reads the log and its inbox. A
  round is bound by that flag's trip through L2.

Above ``SMEM_MAX_M`` a second kernel then applies the rotation log to V,
one row a warp, and writes V in eigenvalue order. Every variant sums each
entry as the plain version does, so on the card K2 reproduces it bit for
bit.

:func:`jacobi_eigh_k2` is the wrapper. A matrix on the CPU goes to the plain
torch version (:func:`jacobi_eigh_k2_reference`, the solver of
ops/jacobi.py with the same sweeps); a matrix on a CUDA device goes to the
kernel, built with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` (ops/kernel_build.py) and bound through ``ctypes`` once.
Anything the kernel does not take raises; nothing falls back. Importing
this module builds nothing.
"""

from __future__ import annotations

import collections
import ctypes
from functools import lru_cache

import numpy as np
import torch

from qilaplace_tpu_torch.ops.jacobi import (
    _tournament_sigma,
    default_sweeps,
    jacobi_eigh,
)
from qilaplace_tpu_torch.ops.kernel_build import load_kernel

SOURCE = "jacobi_eigh.cu"
MAX_M = 512      # must match MAX_M in the CUDA source
SMEM_MAX_M = 84  # must match SMEM_MAX_M: larger m splits G over a cluster
CLUSTER_MAX_M = 320  # must match CLUSTER_MAX_M: larger m splits G over a group


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


@lru_cache(maxsize=None)
def position_moves(m: int) -> tuple:
    """The kernel's table for one round: position p's entries move to
    position ``dst[p]`` for the next round (the inverse of the tournament
    permutation ``sigma``, since ``arrangement_next[p] =
    arrangement[sigma[p]]``). The same table serves every round."""
    return tuple(int(d) for d in np.argsort(_tournament_sigma(m)))


@lru_cache(maxsize=None)
def _dst_table(m: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(position_moves(m), dtype=torch.int32, device=device)


def bind(lib: ctypes.CDLL):
    """The kernel's launch function ``qlt_jacobi_eigh`` and its scratch
    size ``qlt_jacobi_eigh_work_bytes`` in a loaded build of the source,
    with their argument types set."""
    fn = lib.qlt_jacobi_eigh
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    work = lib.qlt_jacobi_eigh_work_bytes
    work.argtypes = [ctypes.c_int] * 4
    work.restype = ctypes.c_size_t
    return fn, work


@lru_cache(maxsize=None)
def _kernel():
    return bind(load_kernel(SOURCE))


def jacobi_eigh_k2(H: torch.Tensor, *, sweeps: int | None = None):
    """K2: ``(lam [..., m] ascending, V [..., m, m])`` of Hermitian ``H``
    ([m, m] or [B, m, m]) after ``sweeps`` Jacobi sweeps (default
    ``default_sweeps(m)``).

    CPU matrix: the plain torch version, any dtype and m. CUDA matrix: the
    kernel, which takes float32 or complex64 with m even, 2 <= m <= 512;
    it returns float32 eigenvalues and V of the input's dtype (a float32
    input runs the real variant). Every launch (for m > SMEM_MAX_M the
    cluster or group kernel and the vector pass, one launch) adds one to
    ``jacobi_eigh_k2.launches`` and to
    ``jacobi_eigh_k2.by_shape[(m, B, "c64" or "f32", sweeps)]``."""
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
    Hc = H.reshape(-1, m, m).contiguous()
    B = Hc.shape[0]
    lam = torch.empty(B, m, dtype=torch.float32, device=H.device)
    V = torch.empty_like(Hc)
    if B:
        cplx = H.is_complex()
        launch, work_bytes = _kernel()
        nbytes = work_bytes(int(cplx), B, m, sweeps)
        work = (torch.empty(nbytes, dtype=torch.uint8, device=H.device)
                if nbytes else None)
        err = launch(
            Hc.data_ptr(), lam.data_ptr(), V.data_ptr(),
            0 if work is None else work.data_ptr(),
            _dst_table(m, H.device).data_ptr(), int(cplx), B, m, sweeps,
            H.device.index, torch.cuda.current_stream(H.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"K2 launch failed: CUDA error {err}")
        jacobi_eigh_k2.launches += 1
        jacobi_eigh_k2.by_shape[(m, B, "c64" if cplx else "f32", sweeps)] += 1
    if squeeze:
        return lam[0], V[0]
    return lam, V


jacobi_eigh_k2.launches = 0
jacobi_eigh_k2.by_shape = collections.Counter()
