"""The ported slice end to end at n=8 against the JAX package.

Cross encode -> analytic build -> direct readout on the 64 (k, l) points of
tests/fixtures/parity_n8.npz. Port and JAX agree to 1e-10 of the peak
(same f64 inputs, same contractions up to summation order). Both sit
within the cutoff's budget of the fixture's closed form: the relative
squared cutoff rule allows ~sqrt(c) * O(0.1..1) per truncation stage,
relative to the unit-norm signal, so at cutoff 1e-12 max |delta| <= 1e-6."""

import functools
import os

import numpy as np
import torch

import qilaplace_tpu as qj
from qilaplace_tpu.scan import pole_scan as jps
from qilaplace_tpu.utils.bits import paired_config_from_kl as j_cfg

import qilaplace_tpu_torch as qt
from qilaplace_tpu_torch.scan.pole_scan import direct_vals
from qilaplace_tpu_torch.utils.bits import paired_config_from_kl
from qilaplace_tpu_torch.utils.interop import mps_from_numpy

from port_helpers import sin_decay

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "fixtures", "parity_n8.npz")
N_BITS, WR = 8, 2 * np.pi


@functools.lru_cache(maxsize=1)
def slice_states():
    """(psi, W) of both packages at n=8, cutoff 1e-12, tight buckets."""
    kw = dict(cutoff=1e-12, maxdim=128)
    psi_j = jps.tighten(qj.signal_ztmps(sin_decay(N_BITS), method="cross",
                                        **kw))
    W_j = jps.tighten(qj.analytic_zt_mpo(N_BITS, WR, dtype=np.complex128,
                                         **kw))
    psi_t = qt.tighten(qt.signal_ztmps_cross(sin_decay(N_BITS), device="cpu",
                                             **kw))
    pack = qt.zt_product_pack(N_BITS, WR, **kw)
    W_t = qt.tighten(qt.mpo_from_pack(pack, device="cpu",
                                      dtype=torch.complex128))
    return psi_j, W_j, psi_t, W_t


def test_slice_n8_against_jax_and_fixture():
    fx = np.load(FIXTURE)
    ks, ls = fx["ks"], fx["ls"]
    want = fx["chi_re"] + 1j * fx["chi_im"]
    psi_j, W_j, psi_t, W_t = slice_states()
    assert psi_t.chain.chi == 4 and W_t.chain.chi * psi_t.chain.chi <= 256
    got_j = np.asarray(jps._direct_vals(W_j, psi_j, j_cfg(ks, ls, N_BITS)))
    got_j = got_j / float(psi_j.amplitude)
    got_t = direct_vals(W_t, psi_t, paired_config_from_kl(ks, ls, N_BITS))
    got_t = got_t.numpy() / float(psi_t.amplitude)
    peak = np.abs(want).max()
    assert np.abs(got_t - got_j).max() <= 1e-10 * peak
    assert np.abs(got_t - want).max() <= 1e-6
    assert np.abs(got_j - want).max() <= 1e-6


def test_direct_routes_agree():
    # chi_eff <= 256 goes through zipper_chain + K1, wider pairs through the
    # factored zipper; the two routes compute the same numbers
    _, _, psi_t, W_t = slice_states()
    wide = qt.repad(psi_t, 8)
    assert W_t.chain.chi * wide.chain.chi > 256
    rng = np.random.default_rng(0)
    cfg = paired_config_from_kl(rng.integers(0, 2**N_BITS, 50),
                                rng.integers(0, 2**N_BITS, 50), N_BITS)
    a = direct_vals(W_t, psi_t, cfg)
    b = direct_vals(W_t, wide, cfg)
    assert (a - b).abs().max() <= 1e-12 * a.abs().max()


def test_chi_grid_direct_matches_jax():
    psi_j, W_j, psi_t, W_t = slice_states()
    ks = np.array([0, 1, 3, 17, 200])
    ls = np.array([0, 5, 64, 255])
    want = np.asarray(jps.chi_grid_direct(W_j, psi_j, ks, ls))
    got = qt.chi_grid_direct(W_t, psi_t, ks, ls).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_z_kl_maps_match_jax():
    for n, wr in ((8, 0.5), (30, 2 * np.pi)):
        for k, l in ((3, 7), (100, 200), (0, 0), (2**n - 1, 2**n - 5)):
            z = qt.z_from_kl(k, l, n, wr)
            assert abs(complex(z) - complex(jps.z_from_kl(k, l, n, wr))) \
                <= 1e-15
            k2, l2 = qt.kl_from_z(z, n, wr)
            assert (int(k2), int(l2)) == (k, l)


def test_pole_search_direct_matches_jax(tmp_path):
    # tests/test_scan.py's direct-readout search (cross encode here, which
    # needs no compile); the state comes from the JAX encoder and is
    # carried over, so both searches read the same state.
    # The port reads the operator artifacts the JAX search wrote (one cache
    # directory), which also checks that the two packages share them.
    n = 8
    j = np.arange(2**n)
    a, w0 = 1.004, 0.7
    x = a**j * np.cos(w0 * j)
    psi_j = qj.signal_ztmps(x, method="cross", cutoff=1e-12, maxdim=64)
    c = psi_j.chain
    psi_t = mps_from_numpy(np.asarray(c.cores), np.asarray(c.ranks),
                           np.asarray(c.amplitude), paired=True, device="cpu")
    kw = dict(coarse_points=64, fine_points=32, superfine_half=4,
              cutoff=1e-12, maxdim=64, readout="direct")
    res_j = qj.coarse_to_fine_pole_search(psi_j, cache_dir=str(tmp_path),
                                          **kw)
    n_artifacts = len(list(tmp_path.glob("zt_analytic_*.npz")))
    res_t = qt.ZTPipeline(n, cache_dir=str(tmp_path),
                          device="cpu").find_poles(psi_t, **kw)
    assert len(list(tmp_path.glob("zt_analytic_*.npz"))) == n_artifacts == 2
    for stage in ("coarse", "fine", "superfine"):
        sj, st = getattr(res_j, stage), getattr(res_t, stage)
        assert int(st.k_peak) == int(sj.k_peak), stage
        assert int(st.l_peak) == int(sj.l_peak), stage
    z_poles = [(1 / a) * np.exp(-1j * w0), (1 / a) * np.exp(1j * w0)]
    assert min(abs(complex(res_t.z_pole) - zp) for zp in z_poles) < 5e-2


def test_apply_readout_not_ported_yet():
    """The routes this test once found missing (the apply-then-read pole
    search and the gate engine) now return results: ``readout="auto"`` on
    a 64-bit state takes the apply route, and ``zt_mpo(engine="gate")``
    builds the gate-folded operator."""
    psi = qt.tighten(qt.signal_ztmps_cross(sin_decay(4), cutoff=1e-12,
                                           device="cpu"))
    assert psi.chain.cores.element_size() >= 8
    res = qt.coarse_to_fine_pole_search(psi, readout="auto", cache=False,
                                        coarse_points=8, fine_points=8,
                                        superfine_half=2, maxdim=32)
    assert res.superfine.chi.shape == (5, 5)
    assert bool(torch.isfinite(torch.view_as_real(res.superfine.chi)).all())
    W = qt.zt_mpo(4, 0.5, engine="gate", cutoff=1e-9, cache=False,
                  device="cpu")
    assert isinstance(W, qt.PairedSiteMPO) and W.chain.n == 8


def test_auto_readout_counts_complex64_as_32_bit(monkeypatch):
    """``readout="auto"`` decides by the real part's width: a complex64
    state is read directly with complex64 operators, as a float32 one is
    (the JAX package's itemsize rule would transform it in complex128 and
    apply it). A float64 state still applies in complex128."""
    import qilaplace_tpu_torch.scan.pole_scan as ps

    built, applied = [], []
    zt_mpo, apply = ps.zt_mpo, ps.apply
    monkeypatch.setattr(ps, "zt_mpo", lambda *a, **kw: (
        built.append(kw["dtype"]), zt_mpo(*a, **kw))[1])
    monkeypatch.setattr(ps, "apply", lambda *a, **kw: (
        applied.append(1), apply(*a, **kw))[1])
    psi = qt.tighten(qt.signal_ztmps_cross(sin_decay(4), cutoff=1e-12,
                                           device="cpu"))
    kw = dict(readout="auto", cache=False, coarse_points=8, fine_points=8,
              superfine_half=2, maxdim=32)
    for dtype, want, applies in ((torch.complex64, torch.complex64, False),
                                 (torch.float32, torch.complex64, False),
                                 (torch.float64, torch.complex128, True)):
        built.clear(), applied.clear()
        res = qt.coarse_to_fine_pole_search(psi.to(dtype=dtype), **kw)
        assert built == [want, want], dtype
        assert bool(applied) is applies, dtype
        assert bool(torch.isfinite(torch.view_as_real(
            res.superfine.chi)).all())


def test_auto_readout_complex64_matches_jax():
    """The same complex64 state through both packages' ``readout="auto"``
    searches: the port reads it directly in complex64, the JAX package
    applies complex128 operators to it and reads the product. The signal
    is the zT tutorial's production one at n = 8 (a pole at angle 0.31,
    off the grid). The two routes find the same peak at every stage, and
    the superfine values agree within float32 roundoff of the direct
    contraction (1e-4 of the peak)."""
    def sig(j):
        j = j.astype(np.float64)
        return np.exp(-2e-3 * j) * np.sin(0.31 * j)

    sig.n_bits = N_BITS
    psi = qj.signal_ztmps(sig, method="cross", cutoff=1e-12, maxdim=128)
    cores = np.asarray(psi.chain.cores).astype(np.complex64)
    ranks = np.asarray(psi.chain.ranks)
    amp = np.asarray(psi.amplitude).astype(np.float32)
    psi_j = qj.ZTMPS(chain=qj.MPS(cores=cores, ranks=ranks, amplitude=amp))
    psi_t = mps_from_numpy(cores, ranks, amp, device="cpu", paired=True)
    kw = dict(readout="auto", cache=False, coarse_points=32, fine_points=16,
              superfine_half=4, maxdim=64)
    res_j = jps.coarse_to_fine_pole_search(psi_j, **kw)
    res_t = qt.coarse_to_fine_pole_search(psi_t, **kw)
    assert np.asarray(res_j.superfine.chi).dtype == np.complex128
    assert res_t.superfine.chi.dtype == torch.complex64
    for stage in ("coarse", "fine", "superfine"):
        sj, st = getattr(res_j, stage), getattr(res_t, stage)
        assert (int(st.k_peak), int(st.l_peak)) == \
            (int(sj.k_peak), int(sj.l_peak)), stage
    assert int(res_t.superfine.l_peak) > 0
    chi_j = np.asarray(res_j.superfine.chi)
    chi_t = res_t.superfine.chi.numpy()
    peak = np.abs(chi_j).max()
    assert np.abs(chi_t - chi_j).max() <= 1e-4 * peak
