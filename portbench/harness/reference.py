"""The plain reference: closed forms of the transforms of the benchmark's
signals, in float64 / complex128 PyTorch.

Frozen from the port's ``signals/oracles.py`` (its geometric series and
the exact reduction of the 2 pi l phase) and ``chip_smoke.sin_spectrum``.
It imports nothing of the port and takes nothing the port made: only the
signal parameters and the grid or frequency indices that the benchmark drew.

For x_j = sum_t a_t sin(w_t j / N) e^{-g_t j / N}, j < N = 2^n, every value
is a pair of geometric series per term, G(u) = (e^{uN} - 1) / (e^u - 1):

* the z-transform grid chi(k, l) = (1/N) sum_j x_j e^{-(wr k + i wi l) j / N},
  with wi = 2 pi and integer l, so the -wi l part of Im(uN) is a whole
  number of turns and is dropped exactly;
* the unitary DFT X_k = N^-1/2 sum_j sin(c j / N) e^{-2 pi i k j / N}.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi
C128 = torch.complex128


def _expm1(u: torch.Tensor) -> torch.Tensor:
    """Complex e^u - 1, by its Taylor series where |u| < 1e-4 (relative
    error under 2e-28 there)."""
    ser = u * (1 + u / 2 * (1 + u / 3 * (1 + u / 4 * (1 + u / 5 * (1 + u / 6)))))
    return torch.where(u.abs() < 1e-4, ser, torch.exp(u) - 1)


def _geom(u: torch.Tensor, uN: torch.Tensor) -> torch.Tensor:
    """G(u) = (e^{uN} - 1) / (e^u - 1), with Im(uN) already reduced."""
    return _expm1(uN) / _expm1(u)


def zt_grid(n: int, ks: torch.Tensor, ls: torch.Tensor, terms, *, wr: float,
            block: int = 1 << 20) -> torch.Tensor:
    """chi at the points (ks[i], ls[i]) (int64, any device) of the signal
    with ``terms`` = [(a_t, w_t, g_t), ...]; complex128, on ks's device."""
    N = float(2**n)
    out = torch.empty(ks.shape[0], dtype=C128, device=ks.device)
    for lo in range(0, ks.shape[0], block):
        k = ks[lo:lo + block].to(torch.float64)
        l = ls[lo:lo + block].to(torch.float64)
        chi = torch.zeros(k.shape, dtype=C128, device=ks.device)
        for a, w, g in terms:
            re_u = -(g + wr * k) / N
            parts = []
            for sign in (1.0, -1.0):
                u = torch.complex(re_u, (sign * w - TWO_PI * l) / N)
                uN = torch.complex(re_u * N, torch.full_like(k, sign * w))
                parts.append(_geom(u, uN))
            chi += (a / 2j) * (parts[0] - parts[1])
        out[lo:lo + block] = chi / N
    return out


def sin_dft(n: int, ks: torch.Tensor, c: float) -> torch.Tensor:
    """Unitary DFT X_k of x_j = sin(c j / N) at the frequencies ks (c a whole
    number); 1 - e^{i t} = -2i sin(t/2) e^{i t/2} keeps the small
    denominators accurate. complex128 on ks's device."""
    N = 2**n
    k = ks.to(torch.float64)

    def G(sign):
        t = sign * c / N - TWO_PI * (k / N)
        den = -2j * torch.sin(t / 2) * torch.exp(1j * t / 2)
        return (1 - complex(math.cos(sign * c), math.sin(sign * c))) / den

    return (G(1.0) - G(-1.0)) / (2j * math.sqrt(N))


def zt_peak(n: int, terms, *, wr: float, device=None) -> float:
    """The largest |chi| of the signal: every pole of ``terms`` lies at
    k = -g / wr, l = +-w / 2 pi with g >= 0 and |w| < 2 pi, so the peak over
    the grid k >= 0 is at k = 0 and |l| <= 3."""
    ls = torch.remainder(torch.arange(-3, 4, device=device), 2**n)
    return float(zt_grid(n, torch.zeros_like(ls), ls, terms, wr=wr)
                 .abs().max())


def err_rel_peak(got: torch.Tensor, want: torch.Tensor,
                 peak: float | None = None) -> float:
    """max |got - want| / ``peak`` (default max |want|); got in any complex
    dtype."""
    got = got.to(device=want.device, dtype=C128)
    gap = float((got - want).abs().max())
    return gap / (float(want.abs().max()) if peak is None else peak)
