"""Bit-ordering helpers.

Counterpart of ``qilaplace_tpu/utils/bits.py``, with the same conventions:
the quantics encoding is big-endian (site 1 = most significant bit),
transform outputs come out bit-reversed, and the paired zT readout
addresses the chain as interleave(lsb(k), lsb(l)). The plain-Python
helpers serve oracles and static index construction; the tensor helpers
build readout configurations on a device.
"""

from __future__ import annotations

import numpy as np
import torch


# ------------------------------ plain python -------------------------------

def int_to_bits(val: int, n: int, *, order: str = "msb") -> list[int]:
    """Bits of ``val`` as a length-``n`` list. ``order``: 'msb' or 'lsb'."""
    if val < 0:
        raise ValueError("int_to_bits: value must be non-negative")
    if val >> n:
        raise ValueError(f"int_to_bits: {val} does not fit in {n} bits")
    bits = [(val >> i) & 1 for i in range(n)]  # lsb-first
    if order == "msb":
        return bits[::-1]
    if order == "lsb":
        return bits
    raise ValueError("order must be 'msb' or 'lsb'")


def bits_to_int(bits, *, order: str = "msb") -> int:
    """Inverse of :func:`int_to_bits`."""
    if order == "msb":
        seq = bits
    elif order == "lsb":
        seq = list(bits)[::-1]
    else:
        raise ValueError("order must be 'msb' or 'lsb'")
    val = 0
    for b in seq:
        val = (val << 1) | (int(b) & 1)
    return val


def bit_reverse(val: int, n: int) -> int:
    """Reverse the n-bit representation of ``val``."""
    return bits_to_int(int_to_bits(val, n, order="lsb"), order="msb")


def interleave_bits(main_bits, copy_bits) -> list[int]:
    """[m1, c1, m2, c2, ...] interleaving for the paired 2n-site register."""
    if len(main_bits) != len(copy_bits):
        raise ValueError("main_bits and copy_bits must have the same length")
    out = []
    for m, c in zip(main_bits, copy_bits):
        out.extend((int(m), int(c)))
    return out


def int_to_paired_bits(val: int, n: int, *, order: str = "msb") -> list[int]:
    """Interleaved [b1, b1, b2, b2, ...] bits of ``val`` (the |j>|j>
    configuration)."""
    b = int_to_bits(val, n, order=order)
    return interleave_bits(b, b)


def bit_reversal_permutation(n: int) -> np.ndarray:
    """Permutation p with p[j] = bit_reverse(j, n); p is an involution."""
    N = 1 << n
    p = np.zeros(N, dtype=np.int64)
    for j in range(N):
        p[j] = bit_reverse(j, n)
    return p


# --------------------------------- tensors ---------------------------------

def tensor_int_to_bits(vals, n: int, *, order: str = "msb",
                       device=None) -> torch.Tensor:
    """Bits of an integer tensor ``vals`` -> int64 ``vals.shape + (n,)``."""
    vals = torch.as_tensor(vals, dtype=torch.int64, device=device)
    shifts = torch.arange(n, device=vals.device)
    if order == "msb":
        shifts = shifts.flip(0)
    elif order != "lsb":
        raise ValueError("order must be 'msb' or 'lsb'")
    return (vals[..., None] >> shifts) & 1


def tensor_interleave_bits(main_bits, copy_bits) -> torch.Tensor:
    """Interleave along the last axis: (..., n) x (..., n) -> (..., 2n)."""
    stacked = torch.stack([main_bits, copy_bits], dim=-1)
    return stacked.reshape(*stacked.shape[:-2], -1)


def paired_config_from_kl(ks, ls, n: int, *, device=None) -> torch.Tensor:
    """(k, l) integer grids -> interleaved LSB-first readout configurations,
    int32 ``(..., 2n)`` on ``device`` (the layout the readout kernel takes)."""
    kb = tensor_int_to_bits(ks, n, order="lsb", device=device)
    lb = tensor_int_to_bits(ls, n, order="lsb", device=kb.device)
    return tensor_interleave_bits(kb, lb).to(torch.int32)
