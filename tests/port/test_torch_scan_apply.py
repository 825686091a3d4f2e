"""The apply-then-read scan and DTPipeline of the port against the JAX
package.

* ``chi_grid`` and ``pole_scan`` on one product state (the JAX package's
  ``apply(analytic_zt_mpo, psi)`` at n = 3, carried over exactly) against
  the JAX functions with ``use_pallas=False``: within 1e-10 of the peak,
  the same peak indices; the port's K1 wrapper (its plain version on the
  CPU) reads the same values;
* ``coarse_to_fine_pole_search(engine="gate", readout="apply")`` at n = 4
  (complex128, cutoff 1e-12, so every zip is an SVD zip and no sketch
  decides anything) on a complex damped exponential: the same peaks at
  every stage, the grids within 1e-10; ``ZTPipeline(engine="gate",
  readout="auto")`` on the 64-bit state takes the same route;
* ``DTPipeline`` at n = 3 in complex128: the same operator ranks, the
  coefficients within 1e-10;
* ``zt_mpo(engine="gate", cache=True)``: an artifact written by either
  package loads in the other.
"""

import numpy as np
import pytest
import torch

import qilaplace_tpu as qj
from qilaplace_tpu.models.pipelines import DTPipeline as JDTPipeline
import qilaplace_tpu_torch as qt
from qilaplace_tpu_torch.utils.interop import mps_from_numpy


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def product_state():
    """The JAX package's zT product state at n = 3 and its port copy."""
    n, wr = 3, 0.75
    x = np.random.default_rng(5).normal(size=2**n)
    out_j = qj.apply(qj.analytic_zt_mpo(n, wr, dtype=np.complex128),
                     qj.signal_ztmps(x, cutoff=1e-14))
    c = out_j.chain
    out_t = mps_from_numpy(np.asarray(c.cores), np.asarray(c.ranks),
                           np.asarray(c.amplitude), paired=True,
                           device="cpu")
    return n, wr, out_j, out_t


def test_chi_grid_matches_jax(product_state):
    n, _, out_j, out_t = product_state
    ks, ls = np.arange(2**n), np.arange(2**n)
    want = np.asarray(qj.chi_grid(out_j, ks, ls, use_pallas=False))
    got = qt.chi_grid(out_t, ks, ls)
    assert got.shape == (8, 8) and got.dtype == torch.complex128
    assert rel(got.numpy(), want) <= 1e-10
    assert rel(qt.chi_grid(out_t, ks, ls, use_kernel=True).numpy(),
               want) <= 1e-10


def test_pole_scan_matches_jax(product_state):
    n, wr, out_j, out_t = product_state
    # a real signal's |chi(k, l)| = |chi(k, N - l)|: one half of l, so the
    # peak is not a tie decided by roundoff
    ks, ls = np.arange(2**n), np.arange(2 ** (n - 1) + 1)
    sj = qj.pole_scan(out_j, ks, ls, wr=wr)
    st = qt.pole_scan(out_t, ks, ls, wr=wr)
    assert (int(st.k_peak), int(st.l_peak)) == (int(sj.k_peak),
                                                int(sj.l_peak))
    assert abs(complex(st.z_peak) - complex(sj.z_peak)) <= 1e-12
    assert rel(st.chi.numpy(), np.asarray(sj.chi)) <= 1e-10
    assert st.wr == sj.wr and st.wi == sj.wi
    pipe = qt.ZTPipeline(n, device="cpu")
    assert torch.equal(pipe.chi_grid(out_t, ks, ls), st.chi)
    assert torch.equal(pipe.scan(out_t, ks, ls, wr=wr).chi, st.chi)


def test_apply_route_pole_search_matches_jax():
    n = 4
    j = np.arange(2**n)
    x = 0.85**j * np.exp(0.9j * j)
    kw = dict(coarse_points=8, fine_points=8, superfine_half=2,
              cutoff=1e-12, maxdim=16, engine="gate", cache=False)
    res_j = qj.coarse_to_fine_pole_search(qj.signal_ztmps(x, cutoff=1e-14),
                                          readout="apply", **kw)
    psi_t = qt.signal_ztmps(x, cutoff=1e-14, device="cpu")
    pipe = qt.ZTPipeline(n, chi=16, build_cutoff=1e-12, engine="gate",
                         readout="auto", cache=False, device="cpu")
    for res_t in (qt.coarse_to_fine_pole_search(psi_t, readout="apply", **kw),
                  pipe.find_poles(psi_t, coarse_points=8, fine_points=8,
                                  superfine_half=2)):
        for stage in ("coarse", "fine", "superfine"):
            sj, st = getattr(res_j, stage), getattr(res_t, stage)
            assert int(st.k_peak) == int(sj.k_peak), stage
            assert int(st.l_peak) == int(sj.l_peak), stage
            assert rel(st.chi.numpy(), np.asarray(sj.chi)) <= 1e-10, stage
        assert abs(complex(res_t.z_pole) - complex(res_j.z_pole)) <= 1e-12


def test_dt_pipeline_matches_jax():
    n, wr = 3, 0.75
    x = np.random.default_rng(5).normal(size=2**n)
    kw = dict(chi=16, dtype=np.complex128)
    pj = JDTPipeline(n, wr, **kw)
    pt = qt.DTPipeline(n, wr, chi=16, dtype=torch.complex128, device="cpu")
    assert pt.mpo.chain.ranks.tolist() == np.asarray(
        pj.mpo.chain.ranks).tolist()
    rng = np.random.default_rng(8)
    ks, js = rng.integers(0, 2**n, 40), rng.integers(0, 2**n, 40)
    want = np.asarray(pj.coefficients(pj.forward(pj.encode(x)), ks, js))
    got = pt.coefficients(pt.forward(pt.encode(x)), torch.from_numpy(ks),
                          torch.from_numpy(js))
    assert got.shape == (40,)
    assert rel(got.numpy(), want) <= 1e-10
    # the closed form: x_j e^{-wr k j / N} / sqrt(N)
    N = 2**n
    closed = x[js] * np.exp(-wr * ks * js / N) / np.sqrt(N)
    assert rel(got.numpy(), closed) <= 1e-6


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gate_artifact_loads_in_both_packages(tmp_path, writer):
    n, wr = 2, 0.75
    kw = dict(engine="gate", cutoff=1e-9, cache=True, cache_dir=str(tmp_path))
    if writer == "port":
        W_w = qt.zt_mpo(n, wr, device="cpu", **kw)
        W_r = qj.zt_mpo(n, wr, **kw)
    else:
        W_w = qj.zt_mpo(n, wr, **kw)
        W_r = qt.zt_mpo(n, wr, device="cpu", **kw)
    assert len(list(tmp_path.glob("zt_gate_*.npz"))) == 1
    c_w = (W_w.chain.cores.numpy() if writer == "port"
           else np.asarray(W_w.chain.cores))
    c_r = (np.asarray(W_r.chain.cores) if writer == "port"
           else W_r.chain.cores.numpy())
    assert c_w.dtype == c_r.dtype == np.complex64
    assert np.array_equal(c_w, c_r)
