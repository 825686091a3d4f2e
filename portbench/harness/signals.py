"""The benchmark's signals, made from the seed.

Frozen from ``bench.py`` / ``chip_smoke.py``: the two zT families and the
QFT's sin(c j / N), with their parameters drawn from the seed inside the
ranges of ``bench.py``'s families. A damped-sine signal is a list of terms
(a_t, w_t, g_t): x_j = sum_t a_t sin(w_t j / N) e^{-g_t j / N}.

* ``sin_decay``: one term, a = 1, w in [0.5, 3.2], g in [0.05, 0.32]
  (``bench.py``'s sin_decay is w = 1, g = 0.25);
* ``multi_sin_exp``: ten terms, a ~ U[0, 1) normalised to unit 2-norm,
  w = (40 / 2 pi) (U - 1/2), g = U / pi (``bench.py``'s ranges, there from
  the fixed seeds 1001, 2002 and 4004).
"""

from __future__ import annotations

import math

import numpy as np


def damped_sines(family: str, rng: np.random.Generator) -> list:
    """One signal's terms [(a, w, g), ...] of ``family``, drawn from
    ``rng``."""
    if family == "sin_decay":
        return [(1.0, float(rng.uniform(0.5, 3.2)),
                 float(rng.uniform(0.05, 0.32)))]
    if family == "multi_sin_exp":
        a = rng.random(10)
        a = a / np.linalg.norm(a)
        w = (40.0 / (2 * math.pi)) * (rng.random(10) - 0.5)
        g = rng.random(10) / math.pi
        return [(float(x), float(y), float(z)) for x, y, z in zip(a, w, g)]
    raise ValueError(f"unknown signal family {family!r}")


def sample_fn(n: int, terms):
    """x as a callable on integer sample indices (numpy float64), with the
    ``n_bits`` attribute the port's cross encoder reads."""
    N = float(2**n)

    def f(j):
        j = np.asarray(j).astype(np.float64)
        out = np.zeros_like(j)
        for a, w, g in terms:
            out += a * np.sin(w * j / N) * np.exp(-g * j / N)
        return out

    f.n_bits = n
    return f


def sin_on_card(n: int, cs, device, chunk: int = 1 << 26):
    """float32 [len(cs), 2^n] rows x_j = sin(c j / N), evaluated in float64
    on ``device`` a chunk at a time."""
    import torch

    N = 2**n
    c = torch.tensor([float(v) for v in cs], dtype=torch.float64,
                     device=device)[:, None] / N
    x = torch.empty(len(cs), N, dtype=torch.float32, device=device)
    for lo in range(0, N, chunk):
        j = torch.arange(lo, min(N, lo + chunk), dtype=torch.float64,
                         device=device)
        x[:, lo:lo + j.numel()] = torch.sin(c * j)
    return x


def qft_freqs(n: int, rng: np.random.Generator, count: int = 4096):
    """``count`` read frequencies (int64 numpy): half in [0, 256) or
    (N - 256, N), where the spectrum of sin(c j / N) peaks, half uniform
    over [0, N) (``chip_smoke.qft_freqs``, drawn from ``rng``)."""
    N = 2**n
    h = count // 2
    near = rng.integers(0, 511, h)
    near = np.where(near < 256, near, N - 511 + near)
    return np.concatenate([near, rng.integers(0, N, count - h)])
