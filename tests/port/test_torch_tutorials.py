"""The port's four tutorials (``qilaplace_tpu_torch.tutorials``) against the
same calls made through the JAX package.

Each tutorial runs on the CPU in complex128, and its returned numbers are
held against the JAX package's (x64, CPU) on the same numpy inputs
(``inputs()`` of each module): deterministic values within 1e-10; the
randomized encodes, whose sketches the two packages draw differently, by
the property the tutorial states. Each tutorial then runs once more in
complex64, against its own complex64 bars. The JAX tutorial scripts are
not executed: they draw figures and write files.

The signal tutorial and the zT tutorial's n = 2 grid fit the fast tier;
the rest take minutes on one core (the DT tutorial's five gate builds
above all) and run in the slow tier."""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import qilaplace_tpu as qj
from qilaplace_tpu.core.mps import coefficient_batch as j_coefficient_batch
from qilaplace_tpu.core.mpo import max_bond as j_max_bond
from qilaplace_tpu.models import DTPipeline as JDTPipeline

from qilaplace_tpu_torch.tutorials import dft, dt, signal, zt
from qilaplace_tpu_torch.utils.bits import int_to_bits, interleave_bits

TOL = 1e-10  # deterministic values, complex128 on both sides


def quiet(fn, *args, **kw):
    with redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def close(a, b, tol=TOL):
    return np.abs(np.asarray(a) - np.asarray(b)).max() <= tol


def ranks(psi):
    return [int(r) for r in np.asarray(psi.ranks)]


def vec(psi, **kw):
    return np.asarray(qj.mps_to_vector(psi, **kw))


# ------------------------------ signal ------------------------------------

def jax_signal(data):
    """The JAX tutorial's calls, on the port tutorial's inputs."""
    n, N = signal.n, signal.N
    x, x_big, x_noisy = data["x"], data["x_big"], data["x_noisy"]
    out = {}
    psi = qj.signal_mps(x, cutoff=1e-12)
    out["ranks"] = ranks(psi)
    out["amplitude"] = float(psi.amplitude)
    out["tensor_norm"] = float(qj.norm(psi))
    bits = int_to_bits(137, n)
    out["reads"] = {
        "integer": float(qj.coefficient(psi, 137).real),
        "bits": float(qj.coefficient(psi, bits).real),
        "index": float(psi[tuple(bits)].real),
    }
    out["reversed_read"] = float(qj.coefficient(psi, bits[::-1]).real)
    out["back"] = vec(psi)
    out["compress"] = {}
    for maxdim in (8, 4, 2):
        small = qj.compress(psi, maxdim=maxdim, tol=1e-10)
        out["compress"][maxdim] = dict(
            ranks=ranks(small), err=float(np.abs(vec(small) - x).max()))
    psi_rand = qj.signal_mps(data["x_rand"], cutoff=1e-12)
    out["mid_rank_random"] = ranks(psi_rand)[n // 2]
    out["rsvd_err"] = float(np.abs(vec(qj.signal_mps(
        x, method="rsvd", k=20, p=5, q=2, cutoff=1e-12)) - x).max())
    p = qj.signal_mps(x_big, cutoff=1e-9, method="svd", maxdim=96)
    out["svd"] = dict(max_bond=max(ranks(p)), rel_err=float(
        np.linalg.norm(vec(p) - x_big) / np.linalg.norm(x_big)))
    p = qj.signal_mps(x_noisy, method="svd", cutoff=1e-9)
    out["noisy_svd"] = dict(max_bond=max(ranks(p)), err=float(
        np.linalg.norm(vec(p) - x_noisy) / np.linalg.norm(x_noisy)))
    p = qj.signal_mps(x_noisy, method="rsvd", cutoff=1e-9, maxdim=10, k=10)
    out["noisy_rsvd"] = dict(max_bond=max(ranks(p)), err=float(
        np.linalg.norm(vec(p) - x_noisy) / np.linalg.norm(x_noisy)))
    return out


def test_signal_tutorial_matches_jax():
    data = signal.inputs()
    for key, kw in (("x", dict(kind="sin", dt=1 / signal.N,
                               freq=[2 * np.pi, 6 * np.pi],
                               phase=[0.2, -0.4])),
                    ("x_big", dict(kind="sin_decay", dt=1 / signal.N,
                                   freq=[2 * np.pi * 5, 2 * np.pi * 17,
                                         2 * np.pi * 23],
                                   decay_rate=[1.25, 1.4, 1.55],
                                   phase=[0.0, 0.4, -0.6]))):
        want = np.asarray(qj.generate_signal(signal.n, dtype="float64", **kw))
        assert close(data[key], want, 1e-12), key
    got = quiet(signal.run, device="cpu", dtype=torch.complex128)
    want = jax_signal(data)
    assert got["ranks"] == want["ranks"]
    for key in ("amplitude", "tensor_norm", "reversed_read"):
        assert close(got[key], want[key]), key
    for key, v in want["reads"].items():
        assert close(got["reads"][key], v), key
    assert close(got["back"], want["back"])
    for maxdim, w in want["compress"].items():
        assert got["compress"][maxdim]["ranks"] == w["ranks"], maxdim
        assert close(got["compress"][maxdim]["err"], w["err"]), maxdim
    assert got["mid_rank_random"] == want["mid_rank_random"] == 32
    assert got["svd"]["max_bond"] == want["svd"]["max_bond"]
    assert close(got["svd"]["rel_err"], want["svd"]["rel_err"])
    assert got["noisy"]["svd_max_bond"] == want["noisy_svd"]["max_bond"]
    assert close(got["noisy"]["svd_err_noisy"], want["noisy_svd"]["err"])
    # the randomized encodes: the property, on both sides
    bars = signal.BARS[torch.complex128]
    assert got["rsvd_err"] < bars["rsvd"] and want["rsvd_err"] < bars["rsvd"]
    assert got["rsvd"]["rel_err"] < bars["encode_rel"]
    for side in (got["noisy"]["rsvd_max_bond"],
                 want["noisy_rsvd"]["max_bond"]):
        assert side == 10
    for side in (got["noisy"]["rsvd_err_noisy"], want["noisy_rsvd"]["err"]):
        assert 0.2 < side < 0.4


def test_signal_tutorial_complex64():
    out = quiet(signal.run, device="cpu", dtype=torch.complex64)
    assert out["mid_rank_random"] == 32 and out["noisy"]["rsvd_max_bond"] <= 10


# -------------------------------- DFT -------------------------------------

def jax_dft(data):
    n, n_big = dft.n, dft.n_big
    x, x_two = data["x"], data["x_two"]
    out = {}
    W = qj.build_qft_mpo(n, cutoff=1e-14)
    out["max_bond"] = int(j_max_bond(W))
    psi = qj.signal_mps(x, cutoff=1e-12)
    exact = qj.compress(qj.apply(W, psi), maxdim=32, tol=1e-10)
    state = qj.apply(W, psi, maxdim=32, cutoff=1e-12)
    out["fused_vs_exact"] = float(np.abs(vec(state) - vec(exact)).max())
    # the JAX tutorial's own call, with no maxdim
    out["exact_uncapped"] = vec(qj.compress(qj.apply(W, psi), tol=1e-10))
    out["spectrum"] = vec(state, reverse=True)
    bins = [0, 4, 8, 12, 500]
    cfgs = np.array([int_to_bits(k, n, order="lsb") for k in bins])
    out["pointwise"] = np.asarray(j_coefficient_batch(state, cfgs))
    W8 = qj.build_qft_mpo(n_big, cutoff=1e-12)
    out["spectrum_two"] = vec(qj.apply(W8, qj.signal_mps(x_two, cutoff=1e-12)),
                              reverse=True)
    return out


@pytest.mark.slow
def test_dft_tutorial_matches_jax():
    data = dft.inputs()
    want_x = np.asarray(qj.generate_signal(
        dft.n, kind="sin", freq=2 * np.pi * 8 / dft.N, dt=1.0,
        dtype="float64"))
    assert close(data["x"], want_x, 1e-12)
    got = quiet(dft.run, device="cpu", dtype=torch.complex128)
    want = jax_dft(data)
    assert got["max_bond"] == want["max_bond"] == dft.PLATEAU
    assert close(got["fused_vs_exact"], want["fused_vs_exact"])
    # the port's maxdim=32 cap on the exact product's compress changes
    # nothing against the JAX tutorial's uncapped call
    assert close(got["exact"], want["exact_uncapped"])
    assert close(got["spectrum"], want["spectrum"])
    fft = np.fft.fft(data["x"]) / np.sqrt(dft.N)
    assert close(got["pointwise_err"],
                 np.abs(want["pointwise"] - fft[[0, 4, 8, 12, 500]]).max())
    assert close(got["spectrum_two"], want["spectrum_two"])
    assert got["k_peak"] == 8


@pytest.mark.slow
def test_dft_tutorial_complex64():
    out = quiet(dft.run, device="cpu", dtype=torch.complex64)
    assert out["k_peak"] == 8


# -------------------------------- DT --------------------------------------

def jax_laplace_values(out_state, n, dt_):
    N = 2**n
    cfgs = np.array([interleave_bits(int_to_bits(k, n, order="lsb"),
                                     int_to_bits(j, n))
                     for k in range(N) for j in range(N)])
    vals = np.asarray(j_coefficient_batch(out_state, cfgs)).reshape(N, N)
    return (dt_ * np.sqrt(N) * vals.sum(axis=1)).real


def jax_dt(data):
    n, N, wr = dt.n, dt.N, dt.wr
    x = data["x"]
    out = {}
    psi_z = qj.signal_ztmps(x, cutoff=1e-12)
    out["ranks"] = ranks(psi_z.chain)
    W = qj.build_dt_mpo(n, wr, cutoff=1e-12)
    out["max_bond"] = int(j_max_bond(W))
    cfg = interleave_bits(int_to_bits(5, n, order="lsb"), int_to_bits(3, n))
    out["coef"] = complex(qj.coefficient(qj.apply(W, psi_z), np.asarray(cfg)))
    pipe = JDTPipeline(n, wr, chi=32, cutoff=1e-10, dtype="complex128")
    out["readout"] = np.asarray(pipe.coefficients(
        pipe.forward(pipe.encode(x)), np.arange(16), np.full(16, 3)))
    out["bond_fine"] = int(j_max_bond(qj.build_dt_mpo(n, 0.5, cutoff=1e-12)))
    W_ex = qj.build_dt_mpo(dt.n_ex, dt.wr_ex, cutoff=1e-12, maxdim=256)
    for key in ("poly", "cos"):
        psi = qj.signal_ztmps(data[f"x_{key}"], cutoff=1e-12, maxdim=256)
        out[f"L_{key}"] = jax_laplace_values(qj.apply(W_ex, psi), dt.n_ex,
                                             dt.dt_ex)
    return out


@pytest.mark.slow
def test_dt_tutorial_matches_jax():
    data = dt.inputs()
    got = quiet(dt.run, device="cpu", dtype=torch.complex128)
    want = jax_dt(data)
    assert got["ranks"] == want["ranks"]
    assert got["max_bond"] == want["max_bond"] == dt.BONDS[dt.wr]
    assert got["probe_bonds"][0.5] == want["bond_fine"] == dt.BONDS[0.5]
    assert close(got["coef"], want["coef"].real)
    assert close(got["readout"], want["readout"])
    assert close(got["L_poly"], want["L_poly"])
    assert close(got["L_cos"], want["L_cos"])


@pytest.mark.slow
def test_dt_tutorial_complex64():
    out = quiet(dt.run, device="cpu", dtype=torch.complex64)
    assert out["laplace_cos_err"] < dt.BARS[torch.complex64]["laplace"]


# -------------------------------- zT --------------------------------------

def jax_zt_grid(x):
    n, N = zt.n, zt.N
    psi_z = qj.signal_ztmps(x, cutoff=1e-14)
    jb = int_to_bits(2, n)
    cfg = interleave_bits(jb, jb)
    amp = complex(qj.coefficient(psi_z, np.asarray(cfg))).real
    amp_index = complex(psi_z[tuple(cfg)]).real
    out = qj.apply(qj.build_zt_mpo(n, zt.wr, cutoff=1e-14), psi_z)
    grid = np.asarray(qj.chi_grid(out, np.arange(N), np.arange(N)))
    return amp, amp_index, grid


def test_zt_tutorial_small_grid_matches_jax():
    """The tutorial's n = 2 section (``zt.small_grid``): the amplitude read
    by coefficient and by ZTMPS indexing, and the 16-point grid, against
    the JAX package; then the same section in complex64."""
    x = zt.inputs()["x"]
    amp, amp_index, grid = jax_zt_grid(x)
    got = quiet(zt.small_grid, device="cpu", dtype=torch.complex128)
    assert close(got["amp"], amp) and close(got["amp_index"], amp_index)
    assert close(amp, x[2]) and close(amp_index, x[2])
    assert close(got["grid"], grid)
    assert close(got["grid"], zt.analytic_grid(x, zt.wr))
    out = quiet(zt.small_grid, device="cpu", dtype=torch.complex64)
    assert out["grid_err"] < zt.BARS[torch.complex64]["grid"]


@pytest.mark.slow
def test_zt_tutorial_matches_jax():
    data = zt.inputs()
    got = quiet(zt.run, device="cpu", dtype=torch.complex128)
    amp, amp_index, grid = jax_zt_grid(data["x"])
    assert close(got["amp"], amp) and close(got["amp_index"], amp_index)
    assert close(got["grid"], grid)
    # n = 10: the rsvd encode draws differently; the stated property
    psi_big = qj.signal_ztmps(data["x_big"], method="rsvd", k=50, p=5, q=2,
                              cutoff=1e-12, maxdim=64)
    res = qj.coarse_to_fine_pole_search(
        psi_big, coarse_points=128, fine_points=64, superfine_half=12,
        cutoff=1e-12, maxdim=64, cache=False)
    z_an = [(1 / zt.a_big) * np.exp(s * 1j * zt.w0_big) for s in (1, -1)]
    want_err = min(abs(complex(res.z_pole) - z) for z in z_an)
    assert got["pole_err"] < zt.POLE_BAR and want_err < zt.POLE_BAR
    # n = 14: the cross encode and the analytic build are deterministic
    psi_prod = qj.signal_ztmps(zt.sig, method="cross", cutoff=1e-10,
                               maxdim=128)
    res = qj.coarse_to_fine_pole_search(
        psi_prod, coarse_points=64, fine_points=64, superfine_half=8,
        cutoff=1e-12, maxdim=128, cache=False)
    assert close(got["z_prod"], complex(res.z_pole))
    assert got["err_prod"] < zt.PROD_BAR


@pytest.mark.slow
def test_zt_tutorial_complex64():
    out = quiet(zt.run, device="cpu", dtype=torch.complex64)
    assert out["err_prod"] < zt.PROD_BAR
