"""QFT elementary gates and the controlled-Hadamard-phase layer MPO.

Counterpart of ``qilaplace_tpu/circuits/qft_gates.py``; the host numpy
gate matrices are copied unchanged. Gate matrices act as ``out = M @ in``
(the MPO core convention W[l, s_out, s_in, r]); the acting order was
verified in the JAX package against the bit-reversed DFT.
"""

from __future__ import annotations

import numpy as np

from qilaplace_tpu_torch.core.mpo import MPO
from qilaplace_tpu_torch.utils.config import dtype_name

I2 = np.eye(2)
H = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2.0)


def P(theta: float) -> np.ndarray:
    """Phase gate diag(1, e^{-i theta}) (the -i convention)."""
    return np.diag([1.0, np.exp(-1j * theta)])


def proj(c: int) -> np.ndarray:
    """Projector |c><c|."""
    M = np.zeros((2, 2))
    M[c, c] = 1.0
    return M


def control_Hphase_mpo(k: int, dtype=np.complex128, *, device=None) -> MPO:
    """One QFT layer on a window of k sites, bond dimension 2, on
    ``device`` (the card unless told otherwise).

    Site 1 acts as H then projects the outcome bit c onto the bond; site l
    (1 < l < k) applies P(2 pi / 2^l) iff c = 1; site k applies
    P(2 pi / 2^k). ``dtype`` is a numpy or torch dtype.
    """
    if k < 1:
        raise ValueError(f"control_Hphase_mpo: k must be >= 1, got {k}")
    dtype = np.dtype(dtype_name(dtype))
    if k == 1:
        return MPO.from_core_list([H.astype(dtype).reshape(1, 2, 2, 1)],
                                  device=device)
    cores = []
    c0 = np.zeros((1, 2, 2, 2), dtype=dtype)
    for c in range(2):
        c0[0, :, :, c] = proj(c) @ H
    cores.append(c0)
    for l in range(2, k):
        W = np.zeros((2, 2, 2, 2), dtype=dtype)
        W[0, :, :, 0] = I2
        W[1, :, :, 1] = P(2 * np.pi / 2**l)
        cores.append(W)
    Wk = np.zeros((2, 2, 2, 1), dtype=dtype)
    Wk[0, :, :, 0] = I2
    Wk[1, :, :, 0] = P(2 * np.pi / 2**k)
    cores.append(Wk)
    return MPO.from_core_list(cores, device=device)
