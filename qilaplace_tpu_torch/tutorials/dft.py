# # Discrete Fourier Transform (QFT) tutorial
#
# Counterpart of docs/tutorials/dft.py (itself of the Julia reference's
# docs/src/tutorials/dft.jl): build the QFT MPO, understand its
# conventions (normalization, sign, bit reversal), apply it to an encoded
# signal, and compare against the dense FFT.
#
# Run: python -m qilaplace_tpu_torch.tutorials.dft [--device cpu]
# [--dtype complex128]
#
# ## 1. What operator are we building?
#
# The QFT MPO realizes the unitary DFT with the -2*pi*i sign convention
# and 1/sqrt(N) normalization,
#     F[k, j] = e^{-2 pi i k j / N} / sqrt(N),
# except that its OUTPUT index comes out bit-reversed: the MPO computes
# Q[j, k] = F[bitrev(j), k]. Bit reversal is intrinsic to the QFT circuit
# — the controlled-phase cascade naturally writes the LEAST significant
# frequency bit onto the first site. Dense FFT implementations hide the
# same reversal inside their butterfly reordering.
"""DFT tutorial: the QFT operator, its apply and three spectrum readouts.
``run(device, dtype)`` returns its numbers; see the package docstring."""

from __future__ import annotations

import numpy as np
import torch

from qilaplace_tpu_torch import (
    apply,
    build_qft_mpo,
    coefficient_batch,
    compress,
    generate_signal,
    max_bond,
    mps_to_vector,
    signal_mps,
)
from qilaplace_tpu_torch.tutorials import check, main, setup
from qilaplace_tpu_torch.utils.bits import bit_reversal_permutation, int_to_bits

n = 10
N = 2**n
n_big = 8
N_big = 2**n_big
freq_big = 2 * np.pi * np.array([8.35, 43.70])
phase_big = np.array([0.0, 0.3])

# The tutorial's facts, per dtype; spectrum errors are relative to the
# peak |X_8| = sqrt(N)/2 = 16 (the two-tone one to its own peak).
# complex128 holds the operator's bond at its plateau of 8 (cutoff 1e-14).
# complex64 builds at float32 roundoff, far above the cutoff: on the
# device route (K2 on an H100, chip_smoke.py) the bond comes out at 5, the
# spectrum 1.2e-3 of the peak from the FFT and the DC bin 2.7e-3 from its
# closed form, as the JAX package's float32 device route does (7.1e-4 at
# n = 10), so its bond is printed and only bounded by the padding bucket,
# 16, and its bars are 1e-2.
BARS = {
    torch.complex128: dict(spectrum=1e-6, apply=1e-5, dc=1e-5),
    torch.complex64: dict(spectrum=1e-2, apply=1e-2, dc=1e-2),
}
PLATEAU = 8  # the QFT operator's bond in complex128 at cutoff 1e-14


def inputs() -> dict:
    """The tutorial's float64 signals: 8 full cycles across n = 10, and the
    off-grid two-tone signal at n = 8."""
    # 8 full cycles across the window -> spectral peak at bin 8
    x = generate_signal(n, kind="sin", freq=2 * np.pi * 8 / N, dt=1.0,
                        dtype=torch.float64, device="cpu").numpy()
    x_two = generate_signal(n_big, kind="sin", dt=1 / N_big,
                            freq=list(freq_big), phase=list(phase_big),
                            dtype=torch.float64, device="cpu").numpy()
    return dict(x=x, x_two=x_two)


def _vec(state, reverse=False) -> np.ndarray:
    return mps_to_vector(state, reverse=reverse).cpu().numpy().astype(
        np.complex128)


def run(device=None, dtype=torch.complex64) -> dict:
    device, rdt = setup(device, dtype)
    bars = BARS[dtype]
    data = inputs()
    x = data["x"]
    on_dev = lambda a: torch.from_numpy(a).to(device, rdt)  # noqa: E731
    out = {}

    # ## 2. Build: the bond dimension plateaus at 8
    #
    # The builder folds n controlled-phase layers into one compressed MPO.
    # The circuit's local ingredients (circuits/qft_gates.py) are the
    # Hadamard and the controlled phase,
    #
    #   H = (1/sqrt 2) [[1, 1], [1, -1]],
    #   P_ij = diag(1, e^{-2 pi i / 2^{j-i+1}}),
    #
    # where P_ij leaves the target alone for control |0> and applies the
    # phase for control |1> — wire i gets one H then controlled phases
    # from every less significant wire j > i. Despite the DFT being a
    # DENSE N x N matrix, the folded MPO's bond dimension saturates at 8
    # under cutoff 1e-14 in complex128 — the central structural fact that
    # makes log-N Fourier analysis possible. Every factorization of the
    # fold on the card runs through kernel K2, in complex64.
    W = build_qft_mpo(n, cutoff=1e-14, dtype=dtype, device=device)
    out["max_bond"] = int(max_bond(W))
    print(f"QFT MPO: max bond = {out['max_bond']} (plateau is {PLATEAU} in "
          "complex128)")

    # ## 3. Apply
    #
    # Exact application multiplies bond dimensions (chi_W * chi_psi) and
    # never truncates; the fused (zip-up) form truncates on the fly and is
    # the performance path. For a rank-3 signal both agree to the cutoff.
    # The exact product here has chi 512; the compress that follows is
    # capped at the fused apply's own budget, maxdim 32, far above the
    # product's true rank. Uncapped, its two-site sweep would sketch at
    # m = 544, beyond K2's m <= 512, which the card sends to the plain
    # Jacobi solver (the JAX package sends it to its lax.scan solver).
    psi = signal_mps(on_dev(x), cutoff=1e-12, device=device)
    out_exact = compress(apply(W, psi), maxdim=32, tol=1e-10)
    state = apply(W, psi, maxdim=32, cutoff=1e-12)
    out["exact"] = _vec(out_exact)
    out["fused_vs_exact"] = float(np.abs(_vec(state) - out["exact"]).max())
    print(f"fused vs exact apply: {out['fused_vs_exact']:.2e}")

    # ## 4. Reading the spectrum — three equivalent ways

    # (a) dense, with reverse=True undoing the bit reversal:
    spec = _vec(state, reverse=True)
    out["spectrum"] = spec
    fft = np.fft.fft(x) / np.sqrt(N)
    peak = np.abs(fft).max()
    out["dense_err"] = float(np.abs(spec - fft).max())
    print("max |QFT - FFT/sqrt(N)|:", out["dense_err"])

    # (b) dense with an explicit permutation:
    raw = _vec(state)
    perm = bit_reversal_permutation(n)
    spec2 = np.zeros_like(raw)
    spec2[perm] = raw
    out["perm_vs_dense"] = float(np.abs(spec2 - spec).max())
    print("permutation route agrees:", out["perm_vs_dense"])

    # (c) pointwise — the form that scales to n = 30, where a dense
    # spectrum cannot exist. To read frequency bin k, feed the
    # BIT-REVERSED configuration (equivalently: k's bits LSB-first):
    bins = np.array([0, 4, 8, 12, 500])
    cfgs = torch.tensor([int_to_bits(int(k), n, order="lsb") for k in bins],
                        device=device)
    vals = coefficient_batch(state, cfgs).cpu().numpy()
    out["pointwise_err"] = float(np.abs(vals - fft[bins]).max())
    print("pointwise reads match FFT:", out["pointwise_err"])

    # ## 5. The dominant frequency
    out["k_peak"] = int(np.argmax(np.abs(spec[: N // 2])))
    print(f"dominant frequency bin: {out['k_peak']} (expect 8)")

    # ## 6. Why this beats the FFT at scale
    #
    # The dense FFT costs O(N log N) and must materialize all N samples.
    # The MPS pipeline costs O(n chi^3) for the encode and
    # O(n chi_W^2 chi^2) for the apply — LOGARITHMIC in N for structured
    # signals. At n >= 34 the dense array stops fitting in memory entirely
    # while the MPS pipeline continues unchanged. The Julia reference
    # reports its own n = 28 figures (docs/src/benchmarking.md of that
    # project); the port's n = 28 QFT path on the card is timed by
    # chip_smoke.py, stage by stage.

    # ## 7. Spectrum analysis of an off-grid two-tone signal
    #
    # A richer test: two sinusoids whose frequencies are deliberately NOT
    # integer multiples of 2*pi/N, so the peaks are broadened and the DC
    # bin is nonzero — both effects predictable in closed form. The
    # generator computes x_j = sum_r sin(Omega_r j + phi_r) with
    # Omega_r = omega_r * dt.
    x_two = data["x_two"]
    psi_two = signal_mps(on_dev(x_two), cutoff=1e-12, device=device)
    W8 = build_qft_mpo(n_big, cutoff=1e-12, dtype=dtype, device=device)
    spec_two = _vec(apply(W8, psi_two), reverse=True)
    out["spectrum_two"] = spec_two
    fft_two = np.fft.fft(x_two) / np.sqrt(N_big)
    out["two_tone_err"] = float(np.abs(spec_two - fft_two).max())
    print(f"two-tone spectrum: max |QFT - FFT| = {out['two_tone_err']:.2e}")

    # Where should the peaks be? Omega_r = freq_r * dt, symmetric pairs at
    # +-Omega_r on the shifted omega in [-pi, pi) axis:
    Om = freq_big / N_big
    print("expected peak angular frequencies:", np.round(Om, 3))

    # The DC bin has the closed form X(0) = (1/sqrt N) sum_j x_j with
    # sum_j sin(Omega j + phi) = sin(N Omega/2) sin(phi + (N-1) Omega/2)
    #                            / sin(Omega/2):
    dc_pred = sum(
        np.sin(N_big * O / 2) * np.sin(p + (N_big - 1) * O / 2) / np.sin(O / 2)
        for O, p in zip(Om, phase_big)
    ) / np.sqrt(N_big)
    out["dc_pred"] = float(dc_pred)
    out["dc"] = float(spec_two[0].real)
    print(f"DC bin: predicted {dc_pred:.6f}, measured {out['dc']:.6f}")

    # What the JAX tutorial's figure plots, the shifted spectrum, is
    # printed here as its two positive-frequency peaks:
    half = np.abs(spec_two[1: N_big // 2])
    top = np.sort(1 + np.argsort(half)[-2:])
    out["peak_bins"] = [int(k) for k in top]
    out["peak_omegas"] = [float(2 * np.pi * k / N_big) for k in top]
    for k, w in zip(top, out["peak_omegas"]):
        print(f"peak: bin {k}, omega {w:.3f}, |X| {abs(spec_two[k]):.4f} "
              f"(|FFT| {abs(fft_two[k]):.4f})")

    # The tutorial's facts:
    check(out["k_peak"] == 8, f"the dominant bin is {out['k_peak']}, not 8")
    check(out["dense_err"] < bars["spectrum"] * peak, "QFT against the FFT")
    check(out["perm_vs_dense"] == 0, "the permutation route is the dense one")
    check(out["pointwise_err"] < bars["spectrum"] * peak,
          "pointwise reads against the FFT")
    check(out["fused_vs_exact"] < bars["apply"] * peak,
          "fused against exact apply")
    if dtype == torch.complex128:
        check(out["max_bond"] == PLATEAU,
              f"the QFT bond is {out['max_bond']}, not the plateau")
    check(1 <= out["max_bond"] <= 16, "the QFT bond within its bucket")
    check(out["two_tone_err"] < bars["spectrum"] * np.abs(fft_two).max(),
          "two-tone spectrum")
    check(abs(out["dc"] - dc_pred) < bars["dc"], "the DC bin's closed form")
    check(np.abs(np.array(out["peak_omegas"]) - Om).max() < 2 * np.pi / N_big,
          "the peaks sit within a bin of Omega_r")
    return out


if __name__ == "__main__":
    main(run)
