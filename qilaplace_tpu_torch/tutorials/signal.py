# # Signal Encoding and Compression
#
# Counterpart of docs/tutorials/signal.py (itself of the Julia reference's
# docs/src/tutorials/signal.jl): how classical signals map onto Matrix
# Product States, how to read the compressed data back, why structured
# signals compress, and where the bit-order pitfalls live.
#
# We write `n` for the number of sites (qubits), so the signal length is
# `N = 2^n`. Run: python -m qilaplace_tpu_torch.tutorials.signal
# [--device cpu] [--dtype complex128]
#
# ## 1. The quantics map
#
# A length-2^n signal x is reshaped into an n-dimensional (2, 2, ..., 2)
# tensor: sample index j = (b1 b2 ... bn)_2 in binary, with **site 1
# carrying the MOST significant bit** (the coarsest scale of the signal).
# Each site of the MPS then holds one binary digit — one spatial SCALE.
# Smooth signals couple scales weakly, so the tensor factorizes into a
# low-rank chain.
"""Signal tutorial: encoding, element reads, compression, SVD against
RSVD. ``run(device, dtype)`` returns its numbers; see the package
docstring."""

from __future__ import annotations

import time

import numpy as np
import torch

from qilaplace_tpu_torch import (
    coefficient,
    coefficient_batch,
    compress,
    generate_signal,
    mps_to_vector,
    norm,
    signal_mps,
    validate,
)
from qilaplace_tpu_torch.tutorials import check, main, setup
from qilaplace_tpu_torch.utils.bits import int_to_bits

n = 10
N = 2**n

# The tutorial's facts, per dtype (absolute bars on samples of size up to
# 2.3, relative bars on 2-norms). complex128 runs the encode in float64,
# where the cutoff's budget (sqrt(1e-12) of the norm 32) sets the error;
# complex64 runs it in float32, whose roundoff is above that budget. The
# randomized encoder's power iterations square the sketch's condition
# number, so in float32 it lands near 1e-3 (1.2e-3 max, 1.7e-3 relative
# on the CPU): its float32 bars are 1e-2.
BARS = {
    torch.complex128: dict(read=1e-6, recon=1e-6, rsvd=1e-6, encode_rel=1e-4,
                           noisy_svd=1e-3),
    torch.complex64: dict(read=1e-4, recon=1e-4, rsvd=1e-2, encode_rel=1e-2,
                          noisy_svd=1e-2),
}
COMPRESS_2 = 0.2  # rank 2 cannot hold two tones: its error is above this


def inputs() -> dict:
    """The tutorial's float64 signals: the two-tone sinusoid, a random
    signal, the decaying three-tone signal and its noisy copy."""
    # A two-tone sinusoid with per-tone phases (vector freq/phase):
    x = generate_signal(n, kind="sin", dt=1 / N, freq=[2 * np.pi, 6 * np.pi],
                        phase=[0.2, -0.4], dtype=torch.float64,
                        device="cpu").numpy()
    # generate_signal(kind="random") draws from torch's generator, the JAX
    # package's from its own; one numpy draw feeds both packages alike.
    x_rand = np.random.default_rng(1234).standard_normal(N)
    x_big = generate_signal(
        n, kind="sin_decay", dt=1 / N,
        freq=[2 * np.pi * 5, 2 * np.pi * 17, 2 * np.pi * 23],
        decay_rate=[1.25, 1.4, 1.55], phase=[0.0, 0.4, -0.6],
        dtype=torch.float64, device="cpu").numpy()
    rng = np.random.default_rng(2026)
    x_noisy = x_big + 0.1 * x_big.std() * rng.standard_normal(x_big.shape)
    return dict(x=x, x_rand=x_rand, x_big=x_big, x_noisy=x_noisy)


def _ranks(psi) -> list[int]:
    return [int(r) for r in psi.ranks.cpu()]


def _vec(psi) -> np.ndarray:
    return mps_to_vector(psi).cpu().numpy().astype(np.float64)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def run(device=None, dtype=torch.complex64) -> dict:
    device, rdt = setup(device, dtype)
    bars = BARS[dtype]
    data = inputs()
    x = data["x"]
    on_dev = lambda a: torch.from_numpy(a).to(device, rdt)  # noqa: E731
    out = {}
    print(f"signal: N={len(x)}, norm={np.linalg.norm(x):.4f}")

    # ## 2. Encoding, and where the norm goes
    #
    # `signal_mps` stores the NORMALIZED signal in the tensor chain and
    # keeps the original 2-norm in `.amplitude`: every coefficient read
    # multiplies the amplitude back in, so the MPS behaves like the
    # original, un-normalized array.
    psi = signal_mps(on_dev(x), cutoff=1e-12, device=device)
    out["ranks"] = _ranks(psi)
    out["amplitude"] = float(psi.amplitude)
    out["tensor_norm"] = float(norm(psi))
    print(f"MPS: n={psi.n} sites, padded chi={psi.chi}, "
          f"bond ranks={out['ranks']}")
    print(f"amplitude={out['amplitude']:.4f}  tensor norm="
          f"{out['tensor_norm']:.6f} (unit by construction)")
    validate(psi)  # structural invariants: boundary ranks, zero padding

    # Two tones -> rank ~4-5 chain: each extra frequency adds O(1) rank,
    # independent of N. That is the whole point of the quantics encoding.

    # ## 3. Reading elements: three equivalent access forms
    j = 137
    bits = int_to_bits(j, n)  # MSB-first, matching the encode convention
    reads = {
        "integer": float(coefficient(psi, j).real),
        "bits": float(coefficient(psi, bits).real),
        "index": float(psi[tuple(bits)].real),
    }
    out["reads"] = reads
    print(f"x[{j}]              = {x[j]: .8f}")
    print(f"integer access      = {reads['integer']: .8f}")
    print(f"bit-array access    = {reads['bits']: .8f}")
    print(f"direct indexing     = {reads['index']: .8f}")

    # The batched form evaluates many configurations in one call (a
    # handful of batched matrix products, not a Python loop per read):
    sel = np.arange(0, N, N // 8)
    cfgs = torch.tensor([int_to_bits(int(t), n) for t in sel], device=device)
    vals = coefficient_batch(psi, cfgs).real.cpu().numpy()
    out["batched_err"] = float(np.abs(vals - x[sel]).max())
    print("batched reads match:", out["batched_err"] < bars["read"])

    # ### Bit-order pitfall
    #
    # MSB-first is the ENCODE convention; transform outputs come out
    # bit-REVERSED (LSB-first). Mixing the two silently reads the value at
    # the bit-reversed index:
    j_rev = int("".join(map(str, bits[::-1])), 2)
    out["reversed_read"] = float(coefficient(psi, bits[::-1]).real)
    print(f"reversed bits read x[{j_rev}] = {out['reversed_read']:.8f} "
          f"(NOT x[{j}])")

    # ## 4. Round trip and truncation error
    #
    # `mps_to_vector` contracts the chain back to a dense vector (small n
    # only). The encode cutoff bounds the RELATIVE SQUARED weight discarded
    # per split (ITensors' rule), so amplitude errors scale like
    # sqrt(cutoff).
    back = _vec(psi)
    out["back"] = back
    out["recon_err"] = float(np.abs(back - x).max())
    print("max reconstruction error:", out["recon_err"])

    out["compress"] = {}
    for maxdim in (8, 4, 2):
        small = compress(psi, maxdim=maxdim, tol=1e-10)
        err = float(np.abs(_vec(small) - x).max())
        out["compress"][maxdim] = dict(ranks=_ranks(small), err=err)
        print(f"compress to maxdim={maxdim}: ranks={_ranks(small)}"
              f" max err={err:.2e}")

    # Rank 2 can no longer hold two tones — the error jumps. Compression is
    # graceful: the best rank-k approximation at each bond (canonical-form
    # truncation).

    # ## 5. Structured vs random signals
    #
    # Random signals have NO scale structure: ranks grow as 2^(n/2) and
    # nothing compresses. Compare the middle-bond rank:
    psi_rand = signal_mps(on_dev(data["x_rand"]), cutoff=1e-12,
                          device=device)
    mid = psi.n // 2
    out["mid_rank"] = out["ranks"][mid]
    out["mid_rank_random"] = _ranks(psi_rand)[mid]
    print(f"middle bond rank: structured={out['mid_rank']} "
          f"random={out['mid_rank_random']} (cap 2^(n/2)={2**(n // 2)})")

    # ## 6. The randomized encoder
    #
    # method='rsvd' replaces each dense split with a randomized
    # range-finder: one big product per split, batched over each level of
    # the divide-and-conquer tree. k/p/q are sketch rank, oversampling, and
    # power iterations. Its Gaussian sketches come from torch's generator,
    # so the port and the JAX package draw different numbers: compare them
    # by their error, not entry by entry.
    psi_r = signal_mps(on_dev(x), method="rsvd", k=20, p=5, q=2,
                       cutoff=1e-12, device=device)
    out["rsvd_err"] = float(np.abs(_vec(psi_r) - x).max())
    print(f"rsvd encode max err: {out['rsvd_err']:.2e}")

    # For signals that do not fit in host memory, generate and encode on
    # the card: generate_signal builds the samples there, signal_mps runs
    # there, and nothing but the chi-sized cores is ever read back.

    # ## 7. Choosing between SVD and RSVD
    #
    # The dense TT-SVD sweep computes the full singular spectrum at every
    # split — a strict error guarantee, at full-spectrum cost, and it will
    # faithfully spend rank on ANYTHING in the data, including noise. The
    # randomized encoder captures only the top-k directions per split: far
    # cheaper on large signals, and a built-in low-pass on unstructured
    # content.
    #
    # Rule of thumb: SVD for small or clean data where guaranteed accuracy
    # matters; RSVD for large or noisy data where the full spectrum is
    # wasted. Timings on a decaying three-tone signal, after one untimed
    # call of each (the first call on the card loads the kernels); the
    # clock is read after the card has finished. At n = 10 both are a few
    # hundred small launches, so the times say more about dispatch than
    # about the two algorithms.
    x_big = data["x_big"]

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def bench_encode(**kw):
        signal_mps(on_dev(x_big), cutoff=1e-9, device=device, **kw)
        synchronize()
        t0 = time.perf_counter()
        p = signal_mps(on_dev(x_big), cutoff=1e-9, device=device, **kw)
        synchronize()
        dt = time.perf_counter() - t0
        return p, dt, _rel(_vec(p), x_big)

    psi_svd, t_svd, e_svd = bench_encode(method="svd", maxdim=96)
    psi_rsvd, t_rsvd, e_rsvd = bench_encode(method="rsvd", maxdim=96, k=10)
    out["svd"] = dict(s=t_svd, max_bond=max(_ranks(psi_svd)), rel_err=e_svd)
    out["rsvd"] = dict(s=t_rsvd, max_bond=max(_ranks(psi_rsvd)),
                       rel_err=e_rsvd)
    print(f"SVD : {t_svd:.4f}s  max bond {out['svd']['max_bond']}"
          f"  rel l2 err {e_svd:.2e}  ({device})")
    print(f"RSVD: {t_rsvd:.4f}s  max bond {out['rsvd']['max_bond']}"
          f"  rel l2 err {e_rsvd:.2e}  ({device})")

    # ## 8. The noisy-signal experiment
    #
    # Add Gaussian noise of 10% of the signal's standard deviation. SVD
    # under a pure cutoff chases every fluctuation — noise has no scale
    # structure, so it looks like entanglement and the bond dimension
    # blows up to the 2^(n/2) cap. RSVD under a hard budget (maxdim=10,
    # k=10) cannot represent the noise at all: it keeps the dominant
    # directions and drops the rest. What it drops is not only noise,
    # though: at this budget its error against the CLEAN signal is about
    # 0.28, above the noise's own 0.1, so here the budget costs signal as
    # well. The contrast is in the bonds: 32 for SVD against 10.
    x_noisy = data["x_noisy"]
    psi_svd_n = signal_mps(on_dev(x_noisy), method="svd", cutoff=1e-9,
                           device=device)
    psi_rsvd_n = signal_mps(on_dev(x_noisy), method="rsvd", cutoff=1e-9,
                            maxdim=10, k=10, device=device)
    rec_svd, rec_rsvd = _vec(psi_svd_n), _vec(psi_rsvd_n)
    out["noisy"] = dict(
        svd_max_bond=max(_ranks(psi_svd_n)),
        svd_err_noisy=_rel(rec_svd, x_noisy),
        rsvd_max_bond=max(_ranks(psi_rsvd_n)),
        rsvd_err_noisy=_rel(rec_rsvd, x_noisy),
        rsvd_err_clean=_rel(rec_rsvd, x_big),
        noise=_rel(x_noisy, x_big),
    )
    nz = out["noisy"]
    print(f"noisy SVD : max bond {nz['svd_max_bond']} "
          f"(blow-up), err vs noisy {nz['svd_err_noisy']:.3f}")
    print(f"noisy RSVD: max bond {nz['rsvd_max_bond']} "
          f"(budgeted), err vs noisy {nz['rsvd_err_noisy']:.3f}, "
          f"err vs CLEAN {nz['rsvd_err_clean']:.3f} "
          f"(the noise: {nz['noise']:.3f})")

    # ## 9. What the figures plot
    #
    # The JAX tutorial draws the reconstructions and the noisy input; here
    # their peak samples are printed instead.
    peak = int(np.argmax(np.abs(x_big)))
    out["peak"] = dict(index=peak, x=float(x_big[peak]),
                       svd=float(_vec(psi_svd)[peak]),
                       rsvd=float(_vec(psi_rsvd)[peak]),
                       noisy_svd=float(rec_svd[peak]),
                       noisy_rsvd=float(rec_rsvd[peak]))
    pk = out["peak"]
    print(f"peak of |x_big| at i={peak}: original {pk['x']:.6f}, SVD "
          f"{pk['svd']:.6f}, RSVD {pk['rsvd']:.6f}; noisy input "
          f"{x_noisy[peak]:.6f}, SVD {pk['noisy_svd']:.6f}, RSVD maxdim=10 "
          f"{pk['noisy_rsvd']:.6f}")

    # The tutorial's facts:
    for how, v in reads.items():
        check(abs(v - x[j]) < bars["read"], f"{how} read {v} vs x[{j}]")
    check(out["batched_err"] < bars["read"], "batched reads")
    check(abs(out["reversed_read"] - x[j_rev]) < bars["read"],
          "the reversed bits read x[j_rev]")
    check(abs(out["tensor_norm"] - 1) < bars["read"], "unit tensor norm")
    check(out["recon_err"] < bars["recon"], "round trip")
    check(max(out["ranks"]) <= 6, "two tones encode at rank <= 6")
    check(out["compress"][4]["err"] < bars["recon"],
          "maxdim 4 holds two tones")
    check(max(out["compress"][2]["ranks"]) == 2
          and out["compress"][2]["err"] > COMPRESS_2,
          "maxdim 2 cannot hold two tones")
    check(out["mid_rank_random"] == 2 ** (n // 2)
          and out["mid_rank"] <= 6, "structured rank against random rank")
    check(out["rsvd_err"] < bars["rsvd"], "rsvd encode")
    for how in ("svd", "rsvd"):
        check(out[how]["rel_err"] < bars["encode_rel"]
              and out[how]["max_bond"] <= 8, f"{how} encode of x_big")
    check(nz["svd_max_bond"] == 2 ** (n // 2)
          and nz["svd_err_noisy"] < bars["noisy_svd"],
          "SVD chases the noise to the rank cap")
    check(nz["rsvd_max_bond"] <= 10
          and nz["rsvd_err_noisy"] > 10 * nz["svd_err_noisy"],
          "RSVD keeps its budget and does not track the noise")
    return out


if __name__ == "__main__":
    main(run)
