# # Discrete Laplace (z-)transform and pole identification
#
# Counterpart of docs/tutorials/zt.py (itself of the Julia reference's
# docs/src/tutorials/zt.jl) — the flagship workflow: encode a damped
# oscillation on the paired register, apply the zT MPO, and locate its
# poles in the complex z-plane by coarse-to-fine |chi| scans.
#
# ## 0. The coordinate system
#
#   chi(k, l) = (1/N) sum_j x_j e^{-(wr k + i wi l) j / N}
#   s(k, l)   = (wr k + i wi l)/N,    z(k, l) = e^{-s(k, l)}
#
# The (k, l) grid samples the z-plane on N radial shells (k, spacing set
# by wr) x N angles (l, spacing wi/N). With n = 30 that is an
# M = N^2 = 2^60-point grid — never materialized: each chi(k, l) is one
# O(n chi^2) contraction, and a whole scan window is ONE batched readout
# (kernel K1 on the card, where it takes the chain). zT = pairedQFT ∘ DT
# (DT acts first); its bond dimension plateaus near 90.
#
# Readout convention: chi(k, l) lives at the interleaved configuration
# [k_bit0, l_bit0, k_bit1, l_bit1, ...] — both registers LSB-first
# (bit-reversed outputs).
#
# Run: python -m qilaplace_tpu_torch.tutorials.zt [--device cpu]
# [--dtype complex128]
"""zT tutorial: the n = 2 grid against the analytic one, the n = 10 pole
search and the n = 14 production path. ``run(device, dtype)`` returns its
numbers; see the package docstring."""

from __future__ import annotations

import numpy as np
import torch

from qilaplace_tpu_torch import (
    apply,
    build_zt_mpo,
    chi_grid,
    coarse_to_fine_pole_search,
    coefficient,
    signal_ztmps,
    z_from_kl,
)
from qilaplace_tpu_torch.tutorials import check, main, setup
from qilaplace_tpu_torch.utils.bits import int_to_bits, interleave_bits

n, N = 2, 4
a, w0 = 0.7, np.pi / 3
wr = 2 * np.pi
n_big = 10
N_big = 2**n_big
a_big = 1.001 * np.exp(1j * 0.002)
w0_big = 0.05
lam_p, w0_p = 2e-4, 0.31
n_prod = 14

# The tutorial's facts, per dtype. The n = 2 grid is exact up to the
# dtype's roundoff (1e-15 in complex128). The n = 10 pole lands within one
# angular step 2 pi / N of z_+- (the finite series has no pole: the
# ridge's offset is resolution-limited, 1.5e-3 in the JAX package), and the
# scanned peak value agrees with the finite series' closed form to the
# truncation budget in complex128, to float32 roundoff in complex64. The
# n = 14 production path's bar is the tutorial's own, 0.05.
BARS = {
    torch.complex128: dict(grid=1e-10, amp=1e-10, peak_value=1e-5),
    torch.complex64: dict(grid=1e-5, amp=1e-5, peak_value=1e-3),
}
POLE_BAR = 2 * np.pi / N_big
PROD_BAR = 0.05


def inputs() -> dict:
    """The tutorial's signals: the n = 2 damped cosine (float64) and the
    n = 10 complex damped oscillation (complex128)."""
    j = np.arange(N)
    jj = np.arange(N_big)
    return dict(x=a**j * np.cos(w0 * j),
                x_big=(a_big**jj) * np.cos(w0_big * jj))


def analytic_grid(x, wr):
    """chi(k, l) on the full N x N grid of an n = 2 signal, in closed form."""
    j = np.arange(N)
    return np.array([[np.sum(x * np.exp(-((wr * k + 2j * np.pi * l) / N) * j))
                      / N for l in range(N)] for k in range(N)])


def chi_finite_reference(z, gamma_p, gamma_m, Nloc):
    """The finite series' closed form at z: one geometric sum per pole."""
    s1 = (1 - (gamma_p * z) ** Nloc) / (1 - gamma_p * z)
    s2 = (1 - (gamma_m * z) ** Nloc) / (1 - gamma_m * z)
    return 0.5 / Nloc * (s1 + s2)


def sig(idx):
    """The production path's signal, read on demand at integer indices."""
    idx = idx.astype(np.float64)
    return np.exp(-lam_p * idx) * np.sin(w0_p * idx)


sig.n_bits = n_prod  # 2^14 samples, read on demand


def _peak_value(stage) -> complex:
    chi = stage.chi.cpu().numpy()
    return complex(chi.flat[np.abs(chi).argmax()])


def small_grid(device=None, dtype=torch.complex64) -> dict:
    """The tutorial's n = 2 section: the paired state's amplitude at
    |2>|2>, read by ``coefficient`` and by indexing, and the 16-point grid
    against the analytic one. Returns those numbers; asserts them."""
    device, rdt = setup(device, dtype)
    bars = BARS[dtype]
    out = {}

    # ## Small pedagogical case: n = 2 (N = 4 samples, paired grid M = 16)
    #
    # The walkthrough signal is a damped cosine
    #
    #   x_j = a^j cos(w0 j),  j = 0..N-1,  a = 0.7, w0 = pi/3.
    x = inputs()["x"]
    print("x =", np.round(x, 4))

    # ## Constructing the ZTMPS
    #
    # The encoded paired state is
    #
    #   |x>_pair = sum_j xhat_j |j>_main |j>_copy,    xhat = x / ||x||_2.
    #
    # Two registers, interleaved site-by-site on one 2n-site chain:
    # - MAIN will carry the transform-output index (k, l bits after the zT),
    # - COPY carries the original sample index, which the controlled
    #   non-unitary damping gates of the zT construction act on.
    psi_z = signal_ztmps(torch.from_numpy(x).to(device, rdt), cutoff=1e-14,
                         device=device)

    # Element access sanity check: the chain holds xhat_j at
    # |j>_main |j>_copy, and every read multiplies the stored amplitude
    # ||x||_2 back in, so the coefficient there is x_j itself.
    # Configuration addressing is MSB-first per register; interleave_bits
    # merges (main, copy) into chain order, and indexing the state with
    # that chain-length tuple reads the same value.
    jb = int_to_bits(2, n)
    cfg = interleave_bits(jb, jb)
    amp = complex(coefficient(psi_z, cfg))
    out["amp"] = amp.real
    out["amp_index"] = complex(psi_z[tuple(cfg)]).real
    print(f"amplitude check: {amp.real:.6f} vs x[2] = {x[2]:.6f} "
          f"(psi_z[{tuple(cfg)}] = {out['amp_index']:.6f})")

    # ## The zT circuit
    #
    # The sampled transform coefficients are
    #
    #   chi(k, l) = (1/2^n) sum_j x_j e^{-(wr k / 2^n) j} e^{-i (wi l / 2^n) j}
    #   s(k, l)   = (wr k + i wi l) / 2^n,     z(k, l) = e^{-s(k, l)}.
    #
    # The imaginary part of s sweeps the angle 0..2*pi (for wi = 2*pi) —
    # the angular scan; the real part sweeps the radius from 1 down to
    # e^{-wr} — the radial scan. Points ON the unit circle (k = 0) are pure
    # oscillations; points inside (k > 0) are damped modes.
    #
    # The operator factors as W_zt = W_qft_paired ∘ W_dt: the DT block
    # contributes the damping e^{-wr k j / 2^n} (controlled non-unitary),
    # the paired QFT contributes the phase e^{-i 2 pi l j / 2^n}. Its gate
    # primitives (circuits/dt_gates.py, circuits/zt_gates.py):
    #
    #   H_d = (1/sqrt 2) [[1, 1], [1, e^{-wr/2}]]        damping Hadamard
    #   H   = (1/sqrt 2) [[1, 1], [1, -1]]               Hadamard
    #   R_lm = diag(1, e^{-wr / 2^{m-l+1}})              controlled damping
    #   P_lm = diag(1, e^{-2 pi i / 2^{m-l+1}})          controlled phase
    #
    # Controlled versions leave the target untouched when the control is
    # |0> and apply the damping/phase factor when it is |1>.
    #
    # Sign convention: the -i phase convention is used in the zT/QFT
    # blocks, so z(k, l) = r_k e^{-i theta_l} and Im z(k, l) = -r_k
    # sin(theta_l).

    # ## Build and apply the zT operator (wr = wi = 2*pi)
    #
    # On the card every factorization of the fold and of the apply is one
    # launch of kernel K2, in complex64.
    W = build_zt_mpo(n, wr, cutoff=1e-14, dtype=dtype, device=device)
    state = apply(W, psi_z)

    # ## All 16 coefficients in one batched readout; compare to the
    # analytic grid
    #
    # chi(k, l) lives at the interleaved LSB-first (k, l) configuration
    # (transform outputs are bit-reversed); chi_grid does the addressing
    # and, on the card, reads the product state through kernel K1.
    grid = chi_grid(state, torch.arange(N), torch.arange(N)).cpu().numpy()
    ref = analytic_grid(x, wr)
    out["grid"] = grid
    out["grid_err"] = float(np.abs(grid - ref).max())
    print("max |chi - analytic|:", out["grid_err"])

    # Full per-point comparison table:
    print(f"  {'(k,l)':<8}  {'chi_num':<22}  {'chi_exact':<22}  "
          f"{'rel err':>9}")
    print("-" * 70)
    for k in range(N):
        for l in range(N):
            g, r_ = grid[k, l], ref[k, l]
            rel = abs(g - r_) / max(abs(r_), np.finfo(np.float64).eps)
            print(f"  ({k},{l})     {g.real:+.5f}{g.imag:+.5f}i   "
                  f"{r_.real:+.5f}{r_.imag:+.5f}i   {rel:9.2e}")

    # The z-plane addresses of the same grid (z = e^{-s}):
    zs_small = np.array([[complex(z_from_kl(k, l, n, wr)) for l in range(N)]
                         for k in range(N)])
    print("z grid =\n", np.round(zs_small, 4))

    check(abs(out["amp"] - x[2]) < bars["amp"]
          and abs(out["amp_index"] - x[2]) < bars["amp"],
          "the paired state's amplitude at |2>|2>")
    check(out["grid_err"] < bars["grid"], "the n = 2 grid against analytic")
    return out


def run(device=None, dtype=torch.complex64) -> dict:
    device, rdt = setup(device, dtype)
    bars = BARS[dtype]
    data = inputs()
    out = small_grid(device, dtype)

    # ## The three-stage search
    #
    # A pole of the signal's z-transform is a peak of |chi| on the grid.
    # The cascade:
    #
    # 1. COARSE — wr = 2 pi spans the whole disk; scan a strided (k, l)
    #    lattice and take the argmax.
    # 2. FINE — rebuild the MPO at wr = 0.5: the same N radial shells now
    #    concentrate near |z| = 1 where physical poles live. The coarse
    #    peak (found in wr = 2 pi coordinates) is REMAPPED into the new
    #    grid via k' = round(-N ln r / wr_fine), l' = round(N theta / wi)
    #    — the z-plane position is the invariant, not the indices
    #    (scan/pole_scan.py kl_from_z). Scan a window around the remap.
    # 3. SUPERFINE — stride-1 window around the fine peak, reusing the
    #    fine transform. Final resolution: dr ~ wr_fine/N radially,
    #    2 pi / N in angle.
    #
    # The search builds each transform once per wr. A complex64 state
    # reads directly, <config| W |psi> per grid point: through kernel K1
    # on the card where the folded chain fits it (chi_W chi_psi <= 256),
    # else through the factored zipper. A complex128 state is applied
    # once per transform and its product state read (readout="auto").

    # ## Pole identification at scale: n = 10, poles near the unit circle
    #
    # The small grid above is too pixelated to resolve pole structure.
    # Pole identification is the flagship application: given a black-box
    # system response (generally non-unitary — the signal decays), the
    # pole locations in the z-plane characterize the system, the bread and
    # butter of system identification and control engineering.
    #
    # The test signal is a COMPLEX damped oscillation with two poles,
    #
    #   x_j = a^j cos(w0 j),   a = |a| e^{i phi},
    #
    # where the complex amplitude deliberately breaks the +/- w0 symmetry
    # the real cosine would have about the real axis. The continuum-limit
    # pole targets are
    #
    #   z_+- = (1/a) e^{+-i w0}.
    #
    # (The reference runs this at n = 20; the tutorial keeps n = 10, and
    # its signal is not scaled up: |a| = 1.001 grows as 1.001^N, which
    # overflows float64 long before n = 20. chip_smoke.py runs the
    # reference tutorial's n = 20 search on the gate path on the card.)
    x_big = data["x_big"]
    psi_big = signal_ztmps(
        torch.from_numpy(x_big).to(device, dtype), method="rsvd", k=50, p=5,
        q=2, cutoff=1e-12, maxdim=64, device=device,
    )

    # What should the transform look like? The finite-sample closed form
    # is a geometric sum per pole: with gamma_+- = a e^{+-i w0} and z the
    # scan point,
    #
    #   chi(z) = (1/2N) [ (1 - (gamma_+ z)^N) / (1 - gamma_+ z)
    #                   + (1 - (gamma_- z)^N) / (1 - gamma_- z) ].
    #
    # Note this FINITE series has no actual pole — the divergence only
    # develops in the N -> infinity limit. A finite, sampled transform
    # shows a sharp |chi| ridge near the analytic z_+- instead, which is
    # exactly what peak-finding locates.
    #
    # The cascade: coarse samples 128 x 128 strided points of the full
    # disk at wr = 2*pi; fine rebuilds the MPO at a smaller wr and scans a
    # window around the remapped coarse peak; superfine scans stride-1
    # around the fine peak. cache=False: the operators are built for this
    # run and no artifact is written.
    res = coarse_to_fine_pole_search(
        psi_big, coarse_points=128, fine_points=64, superfine_half=12,
        cutoff=1e-12, maxdim=64, cache=False,
    )
    z_analytic = ((1 / a_big) * np.exp(-1j * w0_big),
                  (1 / a_big) * np.exp(1j * w0_big))
    z_hat = complex(res.z_pole)
    out["z_coarse"] = complex(res.coarse.z_peak)
    out["z_fine"] = complex(res.fine.z_peak)
    out["z_pole"] = z_hat
    print(f"coarse peak    z = {out['z_coarse']:.6f}")
    print(f"fine peak      z = {out['z_fine']:.6f}")
    print(f"superfine peak z = {z_hat:.6f}")
    print(f"analytic poles   = {z_analytic[0]:.6f}, {z_analytic[1]:.6f}")
    out["pole_err"] = min(abs(z_hat - zp) for zp in z_analytic)
    print("error:", out["pole_err"])

    # Cross-check the scanned peak value against the finite-series closed
    # form at the same z (they agree to the truncation budget — the ridge
    # is real, not a numerical artifact); chi values include the signal
    # amplitude.
    gamma_p = a_big * np.exp(1j * w0_big)
    gamma_m = a_big * np.exp(-1j * w0_big)
    chi_peak_ref = chi_finite_reference(z_hat, gamma_p, gamma_m, N_big)
    chi_peak_got = _peak_value(res.superfine)
    out["peak_abs"], out["peak_abs_ref"] = abs(chi_peak_got), abs(chi_peak_ref)
    print(f"|chi| at peak: scanned {abs(chi_peak_got):.6e} "
          f"vs closed form {abs(chi_peak_ref):.6e}")

    # Why the detected peak is NOT exactly on z_+-: the transform is a
    # finite, discretized z-transform of a sampled signal, while the
    # analytic pole formula describes the ideal infinite series. The
    # method captures the pole signature correctly; finite sampling and
    # grid resolution leave a small, resolution-limited offset (here
    # ~|z|/N-scale) that shrinks as the signal gets longer and the grid
    # finer.

    # ## What the pole-scan figures plot
    #
    # The JAX tutorial scatters |chi| over the z-plane for the three scan
    # stages; here each stage's grid, peak and peak value are printed.
    for name, stage in (("coarse", res.coarse), ("fine", res.fine),
                        ("superfine", res.superfine)):
        print(f"{name}: {len(stage.ks)} x {len(stage.ls)} points at wr = "
              f"{stage.wr:.4f}, peak z = {complex(stage.z_peak):.6f}, "
              f"log10 |chi| = {np.log10(abs(_peak_value(stage))):.4f}")

    # ## The production fast path
    #
    # Everything above used the reference-parity route (rsvd encode,
    # analytic build). Production workloads use three upgrades, all
    # DEFAULT in `coarse_to_fine_pole_search` / `ZTPipeline`:
    #
    # 1. `method="cross"`: TT cross-interpolation reads O(n r^2) ENTRIES
    #    of the signal — pass a CALLABLE with an `n_bits` attribute and the
    #    2^n vector is never materialized (quantics function encoding);
    # 2. `engine="analytic"`: the zT operator is evaluated from its
    #    closed-form kernel (rail crosses + exact Schmidt-product
    #    compression) in host float64, and can be cached as a
    #    per-(n, wr, cutoff) artifact so repeat searches skip the build;
    # 3. `readout="direct"` (auto on 32-bit states): coefficients contract
    #    <config| W |psi> directly, keeping float32 roundoff relative to
    #    the path product instead of the state norm.
    #
    # The cross encode runs in host float64; the chain is cast to the
    # run's width before the search, so a complex64 run reads directly
    # (through K1 on the card) and a complex128 run applies and reads.
    psi_prod = signal_ztmps(sig, method="cross", cutoff=1e-10, maxdim=128,
                            device=device).to(dtype=rdt)
    res_prod = coarse_to_fine_pole_search(
        psi_prod, coarse_points=64, fine_points=64, superfine_half=8,
        cutoff=1e-12, maxdim=128, cache=False,
    )
    z_true = np.exp(-lam_p + 1j * w0_p)
    z_got = complex(res_prod.z_pole)
    out["z_prod"] = z_got
    out["err_prod"] = min(abs(z_got - z_true), abs(z_got - np.conj(z_true)))
    print(f"production path: pole {z_got:.6f} vs analytic {z_true:.6f} "
          f"(err {out['err_prod']:.2e})")

    # The tutorial's facts (the n = 2 ones are checked in small_grid):
    check(out["pole_err"] < POLE_BAR,
          f"n = 10 pole {out['pole_err']:.3e} from z_+-")
    check(abs(out["peak_abs"] - out["peak_abs_ref"])
          < bars["peak_value"] * out["peak_abs_ref"],
          "the peak value against the finite series")
    check(out["err_prod"] < PROD_BAR, "the n = 14 production path")
    return out


if __name__ == "__main__":
    main(run)
