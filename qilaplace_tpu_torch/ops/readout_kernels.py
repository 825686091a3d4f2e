"""Kernel K1: batched coefficient readout of a chain, hand-written for Hopper.

Counterpart of ``qilaplace_tpu/ops/pallas_kernels.py``
(``coefficient_batch_pallas``). The CUDA C++ source is
``qilaplace_tpu_torch/csrc/coefficient_batch.cu``; its header says what
bounds the kernel on the card and how the design answers that.

:func:`coefficient_batch_k1` is the wrapper. A chain on the CPU goes to the
plain torch version (:func:`coefficient_batch_k1_reference`); a chain on a
CUDA device first goes through :func:`pack_live_lanes` (plain torch, on the
device, no host sync), then to the kernel, which is compiled with ``nvcc``
for ``sm_90a`` at first use into ``build/kernels/`` (keyed by a hash of the
source; ops/kernel_build.py) and bound through ``ctypes`` once. Anything
the kernel does not take raises; nothing falls back. Importing this module
builds nothing.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from qilaplace_tpu_torch.core.mps import coefficient_batch
from qilaplace_tpu_torch.ops.kernel_build import load_kernel

SOURCE = "coefficient_batch.cu"
# must match the constants of the CUDA source
MAX_CHI = 256    # widest bond the kernel takes
LANE_TILE = 64   # the kernel's column chunk; packed chains are padded to it


def k1_takes(device, dtype: torch.dtype, chi: int, amplitude) -> bool:
    """The one rule by which callers route a chain readout to K1: a
    complex64 chain on a CUDA device with chi <= MAX_CHI and a real
    amplitude, which is what the kernel takes. Callers decide it up front
    (for a chain that is not formed yet, from what it will be) and read any
    other chain with a plain version in its own dtype; nothing catches the
    kernel's exception."""
    return (torch.device(device).type == "cuda" and dtype == torch.complex64
            and chi <= MAX_CHI
            and not torch.is_complex(torch.as_tensor(amplitude)))


def coefficient_batch_k1_reference(chain, configs) -> torch.Tensor:
    """Plain torch version of K1: for each config row, v = e_0 and
    v <- v @ A[site, :, bit, :] over the sites (both branch products formed,
    each row keeps its bit's), returning ``amplitude * v[:, 0]`` in the
    chain's dtype. The CPU route of the wrapper, and what the card's kernel
    is checked against."""
    return coefficient_batch(chain, configs)


def live_lanes(cores: torch.Tensor) -> torch.Tensor:
    """[n + 1, chi] bool: lane k of inner bond s is live iff column k of
    site s - 1 (either branch) and row k of site s hold a nonzero; at bonds
    0 and n only lane 0 is. A dead lane carries an exact zero into the
    product, or meets an all-zero row, so dropping it is exact."""
    nz = torch.any(cores, dim=2)  # [n, k, j]
    lane0 = (torch.arange(cores.shape[1], device=cores.device) == 0)[None]
    return torch.cat([lane0, nz.any(dim=1)[:-1] & nz.any(dim=2)[1:], lane0])


def pack_live_lanes(cores: torch.Tensor):
    """The kernel's input: ``(packed, widths)``. ``packed`` [n, cp, 2, cp]
    is the chain with the lanes of every bond permuted so that its live
    lanes come first, in their order (lane 0 stays lane 0), zero-padded to
    cp = chi rounded up to 64; ``widths`` int32 [n + 1] counts the live
    lanes of each bond. The permutation is a gauge transform of the chain,
    so the plain version reads ``packed`` to the same numbers, and only
    rows k < widths[s] and columns j < widths[s + 1] of site s matter.
    Two passes over the cores (rows, then columns) after the liveness
    scan; no host sync."""
    n, chi = cores.shape[0], cores.shape[1]
    live = live_lanes(cores)
    widths = live.sum(dim=1, dtype=torch.int32)
    order = torch.argsort((~live).to(torch.uint8), dim=1, stable=True)
    first = torch.arange(0, n * chi, chi, device=cores.device)[:, None]
    rows = cores.reshape(n * chi, 2 * chi).index_select(
        0, (order[:-1] + first).reshape(-1))
    perm = rows.reshape(n, 2 * chi, chi).gather(
        2, order[1:, None, :].expand(n, 2 * chi, chi)).reshape(n, chi, 2, chi)
    cp = -(-chi // LANE_TILE) * LANE_TILE
    if cp == chi:
        return perm, widths
    packed = cores.new_zeros(n, cp, 2, cp)
    packed[:, :chi, :, :chi] = perm
    return packed, widths


def bind(lib: ctypes.CDLL):
    """The kernel's launch function ``qlt_coefficient_batch`` in a loaded
    build of the source, with its argument types set."""
    fn = lib.qlt_coefficient_batch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _kernel():
    return bind(load_kernel(SOURCE))


def coefficient_batch_k1(chain, configs) -> torch.Tensor:
    """K1: ``amplitude * <e_0| prod_site A[site, :, bit, :] |e_0>`` for every
    row of ``configs`` [B, n].

    CPU chain: the plain torch version, any dtype. CUDA chain: the live-lane
    pre-pass (:func:`pack_live_lanes`), then the kernel, which takes
    contiguous complex64 cores with chi <= 256, a real amplitude and
    contiguous int32 configs [B, n] on the same device; it returns complex64
    [B]. Every launch adds one to ``coefficient_batch_k1.launches``."""
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
        packed, widths = pack_live_lanes(cores)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            packed.data_ptr(), widths.data_ptr(), configs.data_ptr(),
            amp.data_ptr(), out.data_ptr(), B, n, packed.shape[1], stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    coefficient_batch_k1.launches += 1
    return out


coefficient_batch_k1.launches = 0
