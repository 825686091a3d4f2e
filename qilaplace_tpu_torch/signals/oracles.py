"""Closed-form transform values for exponentially damped sinusoids.

For x_j = sin(f*dt*j) * e^{-d*dt*j} every transform the package computes is a
pair of geometric series: writing x_j = (e^{a+ j} - e^{a- j}) / (2i) with
a± = ±i*f*dt - d*dt,

    sum_{j=0}^{N-1} x_j e^{-s j} = [G(a+ - s) - G(a- - s)] / (2i),
    G(u) = sum_{j<N} e^{u j} = (e^{uN} - 1) / (e^u - 1).

This gives O(1)-per-point analytic oracles at any n (including n = 30, where
a dense reference sum is 2^30 terms) for:

* the z-transform grid chi(k, l) = (1/N) sum_j x_j e^{-(wr k + i wi l) j / N}
  (reference docs/src/tutorials/zt.jl:85-93),
* the unitary DFT F(k) = (1/sqrt N) sum_j x_j e^{-2 pi i k j / N}
  (reference test/test_qft_transformer.jl:6-19).

Numerical care (all in complex128 on host):

* e^{uN}: the imaginary part of u*N is reduced analytically — for the zT
  exponent Im(u)N = ±f*dt*N - wi*l*N/N = ±f*dt*N - wi*l, and with the
  package's wi = 2 pi and integer l the -wi*l term is an exact multiple of
  2 pi, dropped before evaluation (never compute e^{i*2*pi*l} in floating
  point: the rounding error is ~l*eps radians).
* e^u - 1 for |u| << 1 (small k, l): evaluated by the Taylor series of
  expm1 to avoid catastrophic cancellation (numpy has no complex expm1).

Counterpart of ``qilaplace_tpu/signals/oracles.py`` (numpy only, copied
unchanged so that the port imports nothing of the JAX package); the port's
accuracy checks score against it.
"""

from __future__ import annotations

import numpy as np

TWO_PI = 2.0 * np.pi


def _expm1c(u: np.ndarray) -> np.ndarray:
    """Complex expm1, accurate for small |u| (series) and exact elsewhere."""
    u = np.asarray(u, dtype=np.complex128)
    small = np.abs(u) < 1e-4
    # 6-term Taylor: relative error < |u|^6/7! ~ 2e-28 at |u| = 1e-4
    ser = u * (1 + u / 2 * (1 + u / 3 * (1 + u / 4 * (1 + u / 5 * (1 + u / 6)))))
    direct = np.exp(u) - 1.0
    return np.where(small, ser, direct)


def _geom(re_u: np.ndarray, im_u: np.ndarray, re_uN: np.ndarray,
          im_uN_reduced: np.ndarray) -> np.ndarray:
    """G(u) = (e^{uN} - 1)/(e^u - 1) with the phase of uN supplied already
    reduced mod 2*pi (see module docstring)."""
    num = _expm1c(re_uN + 1j * im_uN_reduced)
    den = _expm1c(re_u + 1j * im_u)
    # u == 0 exactly => G = N; not reachable for d > 0, guard anyway
    safe = np.where(den == 0, 1.0, den)
    return np.where(den == 0, np.nan, num / safe)


def sin_decay_zt_oracle(
    n: int,
    ks,
    ls,
    *,
    wr: float,
    freq: float = 2.0,
    decay_rate: float = 0.5,
    dt: float | None = None,
    wi: float = TWO_PI,
) -> np.ndarray:
    """chi(k, l) of the UNIT-NORM sin_decay signal — matching what the
    pipeline computes after signal_ztmps normalizes the input
    (signals/encode.py _prepare). Returns complex128 [len(ks)].

    The normalization constant is itself evaluated in closed form:
    ||x||^2 = sum_j x_j^2 where x_j^2 expands into three geometric series.
    """
    if dt is None:
        dt = 1.0 / (freq * 2**n)
    N = 2**n
    ks = np.asarray(ks, dtype=np.float64)
    l_int = np.asarray(ls)
    a_re = -decay_rate * dt
    a_im = freq * dt

    # s = (wr k + i wi l)/N; u± = a± - s
    re_u = a_re - wr * ks / N
    re_uN = re_u * N
    # Im(u±) N = ±f dt N - wi l ; the -wi*l part is an exact multiple of
    # 2 pi only when wi == 2 pi and l is integral — reduce it exactly then.
    if abs(wi - TWO_PI) < 1e-15 and np.issubdtype(l_int.dtype, np.integer):
        im_shift = 0.0
    else:
        im_shift = -np.mod(wi * np.asarray(l_int, np.float64), TWO_PI)
    im_u_p = a_im - wi * np.asarray(l_int, np.float64) / N
    im_u_m = -a_im - wi * np.asarray(l_int, np.float64) / N
    g_p = _geom(re_u, im_u_p, re_uN, a_im * N + im_shift)
    g_m = _geom(re_u, im_u_m, re_uN, -a_im * N + im_shift)
    chi = (g_p - g_m) / (2j * N)
    return chi / sin_decay_norm(n, freq=freq, decay_rate=decay_rate, dt=dt)


def sin_decay_dft_oracle(
    n: int,
    ks,
    *,
    freq: float = 2.0,
    decay_rate: float = 0.5,
    dt: float | None = None,
) -> np.ndarray:
    """F(k) = (1/sqrt N) sum_j x_j e^{-2 pi i k j/N} of the unit-norm
    sin_decay signal. Returns complex128 [len(ks)]."""
    if dt is None:
        dt = 1.0 / (freq * 2**n)
    N = 2**n
    k_int = np.asarray(ks)
    a_re = -decay_rate * dt
    a_im = freq * dt
    re_u = np.full(k_int.shape, a_re, dtype=np.float64)
    im_u_p = a_im - TWO_PI * np.asarray(k_int, np.float64) / N
    im_u_m = -a_im - TWO_PI * np.asarray(k_int, np.float64) / N
    if np.issubdtype(k_int.dtype, np.integer):
        im_shift = 0.0  # e^{-i 2 pi k} == 1 exactly
    else:
        im_shift = -np.mod(TWO_PI * np.asarray(k_int, np.float64), TWO_PI)
    g_p = _geom(re_u, im_u_p, re_u * N, a_im * N + im_shift)
    g_m = _geom(re_u, im_u_m, re_u * N, -a_im * N + im_shift)
    F = (g_p - g_m) / (2j * np.sqrt(N))
    return F / sin_decay_norm(n, freq=freq, decay_rate=decay_rate, dt=dt)


def damped_sin_zt_oracle(
    n: int,
    ks,
    ls,
    *,
    wr: float,
    ws,
    lams,
    phs,
    amps,
    wi: float = TWO_PI,
) -> np.ndarray:
    """chi(k, l) of the UNIT-NORM multi-term damped sinusoid
    x_j = sum_t amps[t] sin(ws[t] j + phs[t]) e^{-lams[t] j} — the closed
    form behind every generate_signal family built from damped sines
    (sin, sin_decay, multi_sin, multi_sin_exp). Each term contributes two
    geometric series; the -wi*l phase is dropped exactly when wi == 2 pi
    and l is integral (see module docstring). Returns complex128
    [len(ks)]."""
    N = 2**n
    ks = np.asarray(ks, dtype=np.float64)
    l_int = np.asarray(ls)
    if abs(wi - TWO_PI) < 1e-15 and np.issubdtype(l_int.dtype, np.integer):
        im_shift = 0.0
    else:
        im_shift = -np.mod(wi * np.asarray(l_int, np.float64), TWO_PI)
    lf = np.asarray(l_int, np.float64)
    chi = np.zeros(ks.shape, dtype=np.complex128)
    for w_t, lam_t, ph_t, a_t in zip(
        np.atleast_1d(ws), np.atleast_1d(lams),
        np.atleast_1d(phs), np.atleast_1d(amps),
    ):
        re_u = -lam_t - wr * ks / N
        g_p = _geom(re_u, w_t - wi * lf / N, re_u * N, w_t * N + im_shift)
        g_m = _geom(re_u, -w_t - wi * lf / N, re_u * N, -w_t * N + im_shift)
        chi += (a_t / 2j) * (
            np.exp(1j * ph_t) * g_p - np.exp(-1j * ph_t) * g_m
        )
    chi = chi / N
    return chi / damped_sin_norm(n, ws=ws, lams=lams, phs=phs, amps=amps)


def damped_sin_norm(n: int, *, ws, lams, phs, amps) -> float:
    """||x||_2 of the multi-term damped sinusoid, in closed form: each
    (t, t') pair expands into two cosine geometric series via
    sin A sin B = [cos(A - B) - cos(A + B)] / 2 and
    sum_j cos(Om j + Ph) e^{-c j} = Re[e^{i Ph} G(i Om - c)]."""
    N = 2**n
    ws = np.atleast_1d(np.asarray(ws, np.float64))
    lams = np.atleast_1d(np.asarray(lams, np.float64))
    phs = np.atleast_1d(np.asarray(phs, np.float64))
    amps = np.atleast_1d(np.asarray(amps, np.float64))

    def cos_series(om, ph, c):
        g = _geom(np.asarray(-c), np.asarray(om), np.asarray(-c * N),
                  np.asarray(om * N))
        return float(np.real(np.exp(1j * ph) * g))

    total = 0.0
    for t in range(len(ws)):
        for u in range(len(ws)):
            c = lams[t] + lams[u]
            total += (amps[t] * amps[u] / 2.0) * (
                cos_series(ws[t] - ws[u], phs[t] - phs[u], c)
                - cos_series(ws[t] + ws[u], phs[t] + phs[u], c)
            )
    return float(np.sqrt(max(total, 0.0)))


def sin_decay_norm(
    n: int, *, freq: float = 2.0, decay_rate: float = 0.5,
    dt: float | None = None,
) -> float:
    """||x||_2 of the sin_decay signal, in closed form:
    x_j^2 = e^{2 a_re j} (1 - cos(2 f dt j)) / 2 — three geometric series."""
    if dt is None:
        dt = 1.0 / (freq * 2**n)
    N = 2**n
    a_re = -decay_rate * dt
    a_im = freq * dt
    g0 = _geom(np.array(2 * a_re), np.array(0.0), np.array(2 * a_re * N),
               np.array(0.0))
    g_c = _geom(np.array(2 * a_re), np.array(2 * a_im),
                np.array(2 * a_re * N), np.array(2 * a_im * N))
    total = (np.real(g0) - np.real(g_c)) / 2.0
    return float(np.sqrt(total))
