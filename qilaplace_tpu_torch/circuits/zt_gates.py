"""Paired-register QFT layer for the z-transform.

Counterpart of ``qilaplace_tpu/circuits/zt_gates.py``; the host numpy gate
matrices are copied unchanged. The QFT layer re-laid onto the interleaved
(main, copy) chain: control (project, then H) on copy_k, controlled phases
P(2 pi / 2^{k-j+1}) on copy_{j<k}, identities on every main site.
"""

from __future__ import annotations

import numpy as np

from qilaplace_tpu_torch.circuits.qft_gates import H, I2, P, proj
from qilaplace_tpu_torch.core.mpo import MPO, PairedSiteMPO
from qilaplace_tpu_torch.utils.config import dtype_name


def control_Hphase_ztmps_mpo(k: int, dtype=np.complex128, *,
                             device=None) -> PairedSiteMPO:
    """zT-QFT block on pairs 1..k (2k chain sites), bond dimension 2, on
    ``device`` (the card unless told otherwise). ``dtype`` is a numpy or
    torch dtype."""
    if k < 1:
        raise ValueError(f"control_Hphase_ztmps_mpo: k must be >= 1, got {k}")
    dtype = np.dtype(dtype_name(dtype))
    if k == 1:
        return PairedSiteMPO(chain=MPO.from_core_list(
            [I2.astype(dtype).reshape(1, 2, 2, 1),
             H.astype(dtype).reshape(1, 2, 2, 1)], device=device))
    cores = []
    Wm = np.zeros((1, 2, 2, 2), dtype=dtype)
    Wm[0, :, :, 0] = I2
    Wm[0, :, :, 1] = I2
    cores.append(Wm)
    Wc = np.zeros((2, 2, 2, 2), dtype=dtype)
    Wc[0, :, :, 0] = I2
    Wc[1, :, :, 1] = P(2 * np.pi / 2**k)
    cores.append(Wc)
    for j in range(2, k):
        Wm = np.zeros((2, 2, 2, 2), dtype=dtype)
        Wm[0, :, :, 0] = I2
        Wm[1, :, :, 1] = I2
        cores.append(Wm)
        Wc = np.zeros((2, 2, 2, 2), dtype=dtype)
        Wc[0, :, :, 0] = I2
        Wc[1, :, :, 1] = P(2 * np.pi / 2 ** (k - j + 1))
        cores.append(Wc)
    Wm = np.zeros((2, 2, 2, 2), dtype=dtype)
    Wm[0, :, :, 0] = I2
    Wm[1, :, :, 1] = I2
    cores.append(Wm)
    Wc = np.zeros((2, 2, 2, 1), dtype=dtype)
    for c in range(2):
        Wc[c, :, :, 0] = H @ proj(c)
    cores.append(Wc)
    return PairedSiteMPO(chain=MPO.from_core_list(cores, device=device))
