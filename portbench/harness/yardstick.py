"""The frozen yardstick: published peaks, kernel operation and byte counts,
the tail, the union of device intervals.

Copied from ``chip_smoke.py`` (``PEAK_FP32``, ``PEAK_BYTES``, ``bound``,
``phase_timing``'s and ``phase_k2_timing``'s counts, ``device_busy``'s
union) and ``ops/readout_kernels.py`` (``live_lanes``), so that a later
change to the program cannot move the ruler it is measured by.
"""

from __future__ import annotations

import statistics

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12   # FLOP/s
PEAK_BYTES = 3.35e12  # bytes/s


def bound_s(ops: float, nbytes: float) -> float:
    """The least seconds the card could take: the larger of the operations
    at the float32 peak and the bytes at the memory rate."""
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


def k1_counts(B: int, n: int, widths) -> tuple[float, float]:
    """(operations, bytes) of one K1 launch: ``B`` rows read through an
    ``n``-site chain whose bond s has ``widths[s]`` live lanes. One complex
    multiply-add (8 flops) per (row, k, j) of the selected branch; the live
    part of both branches of every core read once, the int32 configs read
    once and the complex64 results written once."""
    live = float(sum(a * b for a, b in zip(widths[:-1], widths[1:])))
    return 8.0 * B * live, 2 * live * 8 + B * n * 4 + B * 8


def live_widths(cores):
    """Per bond of a [n, chi, 2, chi] chain, the number of live lanes (the
    lanes K1's pre-pass keeps): lane k of inner bond s is live iff column k
    of site s - 1 (either branch) and row k of site s hold a nonzero; at
    bonds 0 and n only lane 0 is. Returns an int32 [n + 1] tensor on the
    chain's device, without a host sync."""
    import torch

    nz = torch.any(cores != 0, dim=2)  # [n, k, j]
    lane0 = (torch.arange(cores.shape[1], device=cores.device) == 0)[None]
    live = torch.cat([lane0, nz.any(dim=1)[:-1] & nz.any(dim=2)[1:], lane0])
    return live.sum(dim=1, dtype=torch.int32)


def k2_counts(m: int, B: int, kind: str, sweeps: int) -> tuple[float, float]:
    """(operations, bytes) of one K2 launch on B Hermitian m x m matrices
    (``kind`` "c64" or "f32") at ``sweeps`` sweeps of m - 1 rounds: each
    round updates the 2x2 blocks of G on both sides and V's column pairs,
    30 m^2 flops complex, 9 m^2 real; H read once, eigenvalues (float32)
    and V written once."""
    rounds = sweeps * (m - 1)
    cplx = kind == "c64"
    elem = 8 if cplx else 4
    flops = B * rounds * (30 if cplx else 9) * m * m
    return float(flops), float(B * (m * m * elem + m * 4 + m * m * elem))


def units_per_s(rec) -> float:
    """The work of the requests that succeeded over the window's seconds."""
    return sum(r.units for r in rec.requests if r.ok) / rec.window_s


def p95(values) -> float:
    """The 95th percentile of every value (inclusive quantiles)."""
    vals = list(values)
    if len(vals) == 1:
        return float(vals[0])
    return statistics.quantiles(vals, n=100, method="inclusive")[94]


def union(intervals) -> list[tuple[float, float]]:
    """Merged, sorted (start, end) intervals."""
    out: list[list[float]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def busy_seconds(events, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] in which some device operation ran."""
    return sum(b - a for a, b in clip(union((e[1], e[2]) for e in events),
                                      lo, hi))
