"""Damping-transform gates: controlled damping blocks on the paired register.

Counterpart of ``qilaplace_tpu/circuits/dt_gates.py``. Both block builders
return a PairedSiteMPO on an interleaved window [main_1, copy_1, ...,
main_L, copy_L]; embed it into the full 2n chain with
ops.apply.embed_window. The gates are not unitary: dampedH and R.

The gate tensors are made with torch on the target device. Every damping
factor ``e^{-wr/2}`` and ``e^{-wr 2^p}`` is evaluated in float64 and cast
to ``dtype`` last, as the JAX package evaluates it at the (x64) precision
of its traced ``wr`` before the cast: a float32 ``exp`` would put about
1e-7 differences into every damping core.
"""

from __future__ import annotations

import numpy as np
import torch

from qilaplace_tpu_torch.circuits.qft_gates import I2, proj
from qilaplace_tpu_torch.core.mpo import PairedSiteMPO, mpo_from_traced
from qilaplace_tpu_torch.utils.config import resolve_device, to_torch_dtype


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def dampedH(wr, dtype=torch.complex128, *, device=None) -> torch.Tensor:
    """(1/sqrt2) [[1, 1], [1, e^{-wr/2}]]: the non-unitary damped
    Hadamard, on ``device`` (the card unless told otherwise)."""
    device = resolve_device(device)
    isq = 1.0 / np.sqrt(2.0)
    out = _f64([[isq, isq], [isq, 0.0]], device)
    out[1, 1] = isq * torch.exp(-_f64(wr, device) / 2.0)
    return out.to(to_torch_dtype(dtype))


def R(wr, dtype=torch.complex128, *, device=None) -> torch.Tensor:
    """diag(1, e^{-wr}): the real damping rotation, on ``device``."""
    device = resolve_device(device)
    out = _f64([[1.0, 0.0], [0.0, 0.0]], device)
    out[1, 1] = torch.exp(-_f64(wr, device))
    return out.to(to_torch_dtype(dtype))


def _core(l, r, dtype, device):
    return torch.zeros(l, 2, 2, r, dtype=dtype, device=device)


def _const(M, dtype, device):
    return torch.as_tensor(np.asarray(M), device=device).to(dtype)


def control_damping_mpo(n: int, k: int, wr, dtype=torch.complex128, *,
                        device=None) -> PairedSiteMPO:
    """Damping block with control on main_k, targets R(wr 2^{l-k-1}) on
    main_{l<k}; identities thread the copy register. Window: pairs 1..k
    (2k chain sites). The control site acts as "project the input bit,
    then dampedH". On ``device`` (the card unless told otherwise)."""
    if k < 1:
        raise ValueError(f"control_damping_mpo: k must be >= 1, got {k}")
    device = resolve_device(device)
    dtype = to_torch_dtype(dtype)
    eye = _const(I2, dtype, device)
    if k == 1:
        cores = [dampedH(wr, dtype, device=device).reshape(1, 2, 2, 1),
                 eye.reshape(1, 2, 2, 1)]
        return PairedSiteMPO(chain=mpo_from_traced(cores))
    cores = []
    for l in range(1, k):
        wfac = _f64(wr, device) * (2.0 ** (l - k - 1))
        Wm = _core(1 if l == 1 else 2, 2, dtype, device)
        Wm[0, :, :, 0] = eye
        Wm[0 if l == 1 else 1, :, :, 1] = R(wfac, dtype, device=device)
        cores.append(Wm)
        Wc = _core(2, 2, dtype, device)
        Wc[0, :, :, 0] = eye
        Wc[1, :, :, 1] = eye
        cores.append(Wc)
    Wm = _core(2, 2, dtype, device)
    dH = dampedH(wr, dtype, device=device)
    for c in range(2):
        Wm[c, :, :, c] = dH @ _const(proj(c), dtype, device)
    cores.append(Wm)
    Wc = _core(2, 1, dtype, device)
    Wc[0, :, :, 0] = eye
    Wc[1, :, :, 0] = eye
    cores.append(Wc)
    return PairedSiteMPO(chain=mpo_from_traced(cores))


def control_damping_copy_mpo(n: int, k: int, wr, dtype=torch.complex128, *,
                             device=None) -> PairedSiteMPO:
    """Damping block with control on copy_k (the projector reads the copy
    bit), targets R(wr 2^{j-2}) on main_{k+j-1}, j = 2..L. Window: pairs
    k..n (L = n-k+1 pairs, 2L chain sites); embed at chain offset 2(k-1).
    On ``device`` (the card unless told otherwise)."""
    if k < 1:
        raise ValueError(f"control_damping_copy_mpo: k must be >= 1, got {k}")
    L = n - k + 1
    if L < 1:
        raise ValueError("control_damping_copy_mpo: window is empty (k > n)")
    device = resolve_device(device)
    dtype = to_torch_dtype(dtype)
    eye = _const(I2, dtype, device)
    if L == 1:
        cores = [eye.reshape(1, 2, 2, 1), eye.reshape(1, 2, 2, 1)]
        return PairedSiteMPO(chain=mpo_from_traced(cores))
    first = _core(1, 1, dtype, device)
    first[0, :, :, 0] = eye
    cores = [first]
    Wc = _core(1, 2, dtype, device)
    for c in range(2):
        Wc[0, :, :, c] = _const(proj(c), dtype, device)
    cores.append(Wc)
    for j in range(2, L + 1):
        wfac = _f64(wr, device) * (2.0 ** (j - 2))
        Wm = _core(2, 2, dtype, device)
        Wm[0, :, :, 0] = eye
        Wm[1, :, :, 1] = R(wfac, dtype, device=device)
        cores.append(Wm)
        # the last copy site closes the bond
        Wc = _core(2, 2 if j < L else 1, dtype, device)
        Wc[0, :, :, 0] = eye
        Wc[1, :, :, 1 if j < L else 0] = eye
        cores.append(Wc)
    return PairedSiteMPO(chain=mpo_from_traced(cores))
