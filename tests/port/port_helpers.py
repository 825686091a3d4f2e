"""Shared inputs of the port tests: random chains and the bench signal."""

import numpy as np


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
