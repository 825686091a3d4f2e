"""Shared inputs of the port tests: random chains and the bench signal.

Imports no JAX: ``chip_smoke.py`` takes its K1 chains from here too."""

import math

import numpy as np
import torch


def random_cores(rng, ranks, phys=(2,)):
    """Complex cores [r_i, *phys, r_{i+1}] of a chain with bond ``ranks``."""
    out = []
    for a, b in zip(ranks[:-1], ranks[1:]):
        shape = (a, *phys, b)
        out.append(rng.normal(size=shape) + 1j * rng.normal(size=shape))
    return out


def rel_err(got, want):
    """max |got - want| / max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def sin_decay(n, freq=2.0, decay=0.5):
    """The bench's closed-form sin_decay signal as a callable:
    x_j = sin(freq dt j) e^{-decay dt j}, dt = 1 / (freq 2^n)."""
    dt = 1.0 / (freq * 2**n)
    w, lam = freq * dt, decay * dt

    def f(j):
        j = j.astype(np.float64)
        return np.sin(w * j) * np.exp(-lam * j)

    f.n_bits = n
    return f


# ------------------------- chains for kernel K1 -----------------------------

# (n, chi, bond ranks, dead lanes): widths off the 64-column tile, a dead
# lane in the middle of a bond, and the zT path's alternating widths
RAGGED = {
    "small": (6, 8, [1, 2, 5, 7, 6, 3, 1], {3: 2}),
    "off-tile": (7, 100, [1, 2, 9, 70, 100, 66, 5, 1], {3: 40, 5: 0}),
    "zt-like": (12, 256, [1, 8, 16, 68, 64, 164, 108, 220, 114, 228, 114, 57,
                          1], {7: 100, 9: 3}),
}


def _chain(cores, ranks, amplitude):
    from qilaplace_tpu_torch import MPS

    return MPS(cores=cores, ranks=ranks, amplitude=torch.tensor(
        amplitude, dtype=cores.real.dtype, device=cores.device))


def random_chain(rng, n, chi, device="cpu", amplitude=1.0):
    """Full-rank random complex64 chain [n, chi, 2, chi]; entries
    ~ N(0, 1/(2 chi)) per part keep |v| O(1) along the chain."""
    scale = 1.0 / math.sqrt(2 * chi)
    cores = (rng.normal(size=(n, chi, 2, chi))
             + 1j * rng.normal(size=(n, chi, 2, chi))) * scale
    return _chain(torch.from_numpy(cores.astype(np.complex64)).to(device),
                  torch.full((n + 1,), chi, dtype=torch.int32, device=device),
                  amplitude)


def ragged_chain(rng, n, chi, ranks, dead, device="cpu",
                 dtype=torch.complex64):
    """Chain [n, chi, 2, chi] with bond ``ranks`` zero-padded to chi;
    ``dead`` maps a bond to a lane inside its rank whose column at the site
    before is zeroed (a dead lane in the middle of the bond)."""
    cores = np.zeros((n, chi, 2, chi), dtype=np.complex128)
    for s in range(n):
        a, b = ranks[s], ranks[s + 1]
        cores[s, :a, :, :b] = (rng.normal(size=(a, 2, b)) + 1j * rng.normal(
            size=(a, 2, b))) / math.sqrt(2 * a)
    for bond, lane in dead.items():
        cores[bond - 1, :, :, lane] = 0
    return _chain(torch.from_numpy(cores).to(device, dtype),
                  torch.tensor(ranks, dtype=torch.int32, device=device), 0.9)


def embed(chain, chi_big, rng):
    """The same chain with extra dead lanes: its lanes at sorted random
    positions (lane 0 kept at 0) of a chi_big bond."""
    n, chi = chain.n, chain.chi
    pos = np.concatenate([[0], np.sort(rng.choice(
        np.arange(1, chi_big), chi - 1, replace=False))])
    idx = torch.from_numpy(pos).to(chain.cores.device)
    rows = chain.cores.new_zeros(n, chi_big, 2, chi)
    rows[:, idx] = chain.cores
    big = chain.cores.new_zeros(n, chi_big, 2, chi_big)
    big[..., idx] = rows
    return _chain(big, chain.ranks, float(chain.amplitude))
