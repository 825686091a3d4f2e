"""Deterministic test and benchmark signal generators.

Counterpart of ``qilaplace_tpu/signals/generate.py``: the same kinds
(``sin``, ``multi_sin``, ``sin_decay``, ``multi_sin_exp``,
``abs_cos_power_p8``, ``random``) with the same auto time step
dt = 1 / (f_max 2^n). Signals are made on ``device`` (the card unless told
otherwise), in ``dtype``, so n = 28 (2^28 samples, 1 GiB in float32)
never touches the host; each term is evaluated in place, so the peak is
three signal-sized buffers. The seeded parameters of ``multi_sin`` and
``multi_sin_exp`` come from numpy generators, as in the JAX package, so
those signals match it; ``random`` and the ``sin`` kind's ``noise_level``
draw from a ``torch.Generator`` seeded with the same integer, whose
numbers differ from JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

from qilaplace_tpu_torch.utils.config import resolve_device, to_torch_dtype

_LEGACY_N_TERMS = 10


def _damped_sin(n: int, w, lam, ph, amp, dtype, device) -> torch.Tensor:
    """sum_t amp_t sin(w_t j + ph_t) e^{-lam_t j} for j = 0..2^n-1, with the
    parameters cast to ``dtype`` first and every term evaluated in
    ``dtype`` (as the JAX package does)."""
    T = max(np.size(w), np.size(lam), np.size(ph), np.size(amp))
    full = [np.broadcast_to(np.atleast_1d(np.asarray(v, np.float64)), (T,))
            for v in (w, lam, ph, amp)]
    params = torch.tensor(np.stack(full), dtype=dtype)  # [4, T] on the host
    j = torch.arange(2**n, dtype=dtype, device=device)
    out = torch.zeros_like(j)
    damped = (params[1] != 0).tolist()
    for (w_t, lam_t, ph_t, a_t), decays in zip(params.T.to(device), damped):
        term = torch.mul(j, w_t).add_(ph_t).sin_()
        if decays:
            term.mul_(torch.mul(j, -lam_t).exp_())
        out.add_(term.mul_(a_t))
    return out


def generate_signal(n: int, *, kind: str = "sin", dt: float | None = None,
                    freq=None, dtype=torch.float32, device=None,
                    **kwargs) -> torch.Tensor:
    """Length-2^n real signal on ``device`` (the card unless told
    otherwise)."""
    device = resolve_device(device)
    dtype = to_torch_dtype(dtype)
    if kind == "random":
        gen = torch.Generator().manual_seed(int(kwargs.get("seed", 1234)))
        return torch.randn(2**n, generator=gen, dtype=dtype).to(device)

    freq_val = (2 * np.pi) if freq is None else freq
    freq_arr = np.atleast_1d(np.asarray(freq_val, dtype=np.float64))
    if dt is None:
        f_max = float(np.max(np.abs(freq_arr)))
        dt = 1.0 if f_max == 0 else 1.0 / (f_max * 2**n)
    dt = float(dt)

    if kind == "sin":
        phase = kwargs.get("phase", 0.0)
        phase_arr = (
            np.zeros_like(freq_arr)
            if phase is None
            else np.atleast_1d(np.asarray(phase, dtype=np.float64))
        )
        if np.isscalar(freq_val) or np.asarray(freq_val).ndim == 0:
            phase_arr = phase_arr[:1]
        else:
            if phase is None or np.asarray(phase).ndim == 0:
                phase_arr = np.zeros_like(freq_arr) + phase_arr[0]
            if len(phase_arr) != len(freq_arr):
                raise ValueError("freq and phase vectors must have equal length")
        out = _damped_sin(n, freq_arr * dt, 0.0, phase_arr, 1.0, dtype, device)
        noise = float(kwargs.get("noise_level", 0.0))
        if noise > 0:
            gen = torch.Generator().manual_seed(int(kwargs.get("seed", 0)))
            out = out + noise * torch.randn(out.shape, generator=gen,
                                            dtype=dtype).to(device)
        return out

    if kind == "multi_sin":
        n_terms = int(kwargs.get("n_terms", _LEGACY_N_TERMS))
        rng_a = np.random.default_rng(int(kwargs.get("seed_amp", 1001)))
        rng_w = np.random.default_rng(int(kwargs.get("seed_freq", 2002)))
        omega_scale = float(kwargs.get("omega_scale", 40.0))
        ak = rng_a.random(n_terms)
        ak = ak / np.linalg.norm(ak)
        wk = (omega_scale * dt) * (rng_w.random(n_terms) - 0.5)
        return _damped_sin(n, wk, 0.0, 0.0, ak, dtype, device)

    if kind == "sin_decay":
        decay = kwargs.get("decay_rate", 1.0)
        phase = kwargs.get("phase", None)
        decay_arr = np.atleast_1d(np.asarray(decay, dtype=np.float64))
        if np.asarray(freq_val).ndim == 0:
            ph = 0.0 if phase is None else float(np.atleast_1d(phase)[0])
            return _damped_sin(n, freq_arr[:1] * dt, decay_arr[:1] * dt, ph,
                               1.0, dtype, device)
        if len(decay_arr) != len(freq_arr):
            raise ValueError("freq and decay_rate vectors must have equal length")
        phase_arr = (
            np.zeros_like(freq_arr)
            if phase is None
            else np.atleast_1d(np.asarray(phase, dtype=np.float64))
        )
        if len(phase_arr) != len(freq_arr):
            raise ValueError("freq and phase vectors must have equal length")
        return _damped_sin(n, freq_arr * dt, decay_arr * dt, phase_arr, 1.0,
                           dtype, device)

    if kind == "multi_sin_exp":
        n_terms = int(kwargs.get("n_terms", _LEGACY_N_TERMS))
        rng_a = np.random.default_rng(int(kwargs.get("seed_amp", 1001)))
        rng_w = np.random.default_rng(int(kwargs.get("seed_freq", 2002)))
        rng_l = np.random.default_rng(int(kwargs.get("seed_decay", 4004)))
        omega_scale = float(kwargs.get("omega_scale", 40.0))
        lam_scale = float(kwargs.get("lambda_scale", 2.0))
        ak = rng_a.random(n_terms)
        ak = ak / np.linalg.norm(ak)
        wk = (omega_scale * dt) * (rng_w.random(n_terms) - 0.5)
        lk = -(lam_scale * dt) * rng_l.random(n_terms)
        return _damped_sin(n, wk, -lk, 0.0, ak, dtype, device)

    if kind == "abs_cos_power_p8":
        power = float(kwargs.get("power", 0.8))
        w = torch.tensor(2 * np.pi * dt, dtype=dtype).to(device)
        j = torch.arange(2**n, dtype=dtype, device=device)
        return j.mul_(w).cos_().abs_().pow_(power)

    raise ValueError(
        f"Unsupported signal kind: {kind}. Supported: sin, multi_sin, "
        "sin_decay, multi_sin_exp, abs_cos_power_p8, random."
    )
