"""Which readout reads a chain: K1 where it takes the chain, a plain
version in the chain's own dtype everywhere else.

``readout_kernels.k1_takes`` is the one rule: a complex64 chain on a CUDA
device with chi <= 256 and a real amplitude. ``direct_vals`` (behind
``chi_grid_direct``, ``ZTPipeline.chi_grid_direct`` and the pole search's
``readout="direct"``), ``chi_grid`` and ``QFTPipeline.spectrum`` decide by
it up front. The CPU tests hold the rule and the routing to it on small
stand-in objects; the GPU tests (marker ``gpu``, skipped without a card)
read complex128 states, and chi > 256 states through ``spectrum``, on the
card and hold each against the same call on the CPU: within 1e-10
relative in complex128, and K1's launch count does not move. No JAX
import, so the GPU tests run where only the port is installed:

    python -m pytest tests/port/test_torch_readout_routes.py -m gpu --confcutdir=tests/port
"""

import math
import types

import numpy as np
import pytest
import torch

import qilaplace_tpu_torch as qt
from qilaplace_tpu_torch.models import pipelines
from qilaplace_tpu_torch.ops import readout_kernels as rk
from qilaplace_tpu_torch.scan import pole_scan

from port_helpers import random_chain, sin_decay

N_BITS = 8      # the zT operands' size on the card: chi_eff <= 256
TOL_C128 = 1e-10

CUDA = torch.device("cuda", 0)  # a device object only: no card needed


def chain_like(device, dtype, chi, amplitude=1.0):
    """A stand-in for an MPS: what the routes read of a chain."""
    cores = types.SimpleNamespace(device=torch.device(device))
    cores.contiguous = lambda: cores
    return types.SimpleNamespace(cores=cores, dtype=dtype, chi=chi,
                                 amplitude=torch.tensor(amplitude),
                                 device=torch.device(device), ranks=None)


@pytest.mark.parametrize("device,dtype,chi,amplitude,takes", [
    (CUDA, torch.complex64, 256, 1.0, True),
    (CUDA, torch.complex64, 1, 2.5, True),
    (CUDA, torch.complex128, 256, 1.0, False),
    (CUDA, torch.complex64, 257, 1.0, False),
    (CUDA, torch.complex64, 256, 1.0 + 0.5j, False),
    ("cpu", torch.complex64, 256, 1.0, False),
])
def test_k1_takes(device, dtype, chi, amplitude, takes):
    assert rk.k1_takes(device, dtype, chi, torch.tensor(amplitude)) is takes


@pytest.mark.parametrize("takes", [True, False])
def test_chi_grid_routes_by_k1_takes(monkeypatch, takes):
    """chi_grid asks k1_takes of the state's chain and reads through K1's
    wrapper or the plain coefficient_batch by its answer."""
    asked, taken = [], []
    monkeypatch.setattr(pole_scan, "k1_takes",
                        lambda *a: asked.append(a) or takes)
    monkeypatch.setattr(pole_scan, "coefficient_batch_k1",
                        lambda mps, cfg: taken.append("k1") or
                        torch.zeros(cfg.shape[0], dtype=torch.complex64))
    monkeypatch.setattr(pole_scan, "coefficient_batch",
                        lambda chain, cfg: taken.append("plain") or
                        torch.zeros(cfg.shape[0], dtype=torch.complex64))
    chain = random_chain(np.random.default_rng(3), 4, 3)
    psi_out = types.SimpleNamespace(chain=chain, n=2)
    grid = pole_scan.chi_grid(psi_out, [0, 1], [0, 1, 2])
    assert grid.shape == (2, 3)
    assert asked == [(chain.cores.device, chain.dtype, chain.chi,
                      chain.amplitude)]
    assert taken == ["k1" if takes else "plain"]


@pytest.mark.parametrize("device,w_dtype,psi_dtype,chi_psi,amplitude,route", [
    (CUDA, torch.complex64, torch.float32, 16, 1.0, "k1"),
    (CUDA, torch.complex128, torch.float64, 16, 1.0, "factored"),
    (CUDA, torch.complex64, torch.complex128, 16, 1.0, "factored"),
    (CUDA, torch.complex64, torch.float32, 17, 1.0, "factored"),
    (CUDA, torch.complex64, torch.complex64, 16, 1.0 + 1.0j, "factored"),
    ("cpu", torch.complex128, torch.float64, 16, 1.0, "k1"),
    ("cpu", torch.complex64, torch.float32, 17, 1.0, "factored"),
])
def test_direct_vals_routes(monkeypatch, device, w_dtype, psi_dtype, chi_psi,
                            amplitude, route):
    # W has chi 16: chi_eff = 16 chi_psi, 256 at chi_psi = 16
    taken = []
    monkeypatch.setattr(pole_scan, "zipper_chain", lambda W, psi: "chain")
    monkeypatch.setattr(pole_scan, "coefficient_batch_k1",
                        lambda chain, cfg: taken.append(("k1", chain)))
    monkeypatch.setattr(pole_scan, "apply_coefficient_batch",
                        lambda W, psi, cfg: taken.append(("factored", None)))
    W = types.SimpleNamespace(chain=types.SimpleNamespace(chi=16,
                                                          dtype=w_dtype))
    psi = types.SimpleNamespace(
        chain=chain_like(device, psi_dtype, chi_psi, amplitude))
    pole_scan.direct_vals(W, psi, None)
    assert taken == [(route, "chain" if route == "k1" else None)]


@pytest.mark.parametrize("device,dtype,chi,amplitude,route", [
    (CUDA, torch.complex64, 256, 1.0, "k1"),
    (CUDA, torch.complex128, 64, 1.0, "plain"),
    (CUDA, torch.complex64, 257, 1.0, "plain"),
    (CUDA, torch.complex64, 64, 1.0 - 2.0j, "plain"),
    ("cpu", torch.complex64, 64, 1.0, "plain"),
])
def test_spectrum_routes(monkeypatch, device, dtype, chi, amplitude, route):
    taken = []
    monkeypatch.setattr(pipelines, "tensor_int_to_bits",
                        lambda f, n, order, device: torch.zeros(1, n))
    monkeypatch.setattr(pipelines, "coefficient_batch_k1",
                        lambda chain, cfg: taken.append("k1"))
    monkeypatch.setattr(pipelines, "coefficient_batch",
                        lambda psi, cfg: taken.append("plain"))
    pipe = object.__new__(qt.QFTPipeline)  # spectrum reads only n
    pipe.n = 4
    pipe.spectrum(chain_like(device, dtype, chi, amplitude), [0, 1])
    assert taken == [route]


# ------------------------------ on the card ---------------------------------

def rel(got, want):
    got, want = got.cpu().to(torch.complex128), want.cpu().to(torch.complex128)
    return float((got - want).abs().max() / want.abs().max())


def zt_operands(device):
    """The n = 8 sin_decay state (float64) and the analytic zT operator in
    complex128 on ``device``."""
    psi = qt.tighten(qt.signal_ztmps_cross(sin_decay(N_BITS), cutoff=1e-12,
                                           device="cpu"))
    pack = qt.zt_product_pack(N_BITS, 2 * math.pi, cutoff=1e-12, maxdim=128)
    W = qt.tighten(qt.mpo_from_pack(pack, device=device,
                                    dtype=torch.complex128))
    return W, psi.to(device)


def grid(seed=8):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 2**N_BITS, 12)),
            torch.from_numpy(rng.integers(0, 2**N_BITS, 10)))


@pytest.mark.gpu
def test_chi_grid_direct_complex128_on_card(cuda_device):
    ks, ls = grid()
    W, psi = zt_operands("cpu")
    assert W.chain.chi * psi.chain.chi <= rk.MAX_CHI  # K1's width
    want = qt.chi_grid_direct(W, psi, ks, ls)
    Wd, psid = zt_operands(cuda_device)
    before = rk.coefficient_batch_k1.launches
    got = qt.chi_grid_direct(Wd, psid, ks.to(cuda_device), ls.to(cuda_device))
    assert rk.coefficient_batch_k1.launches == before
    assert got.dtype == torch.complex128 and got.device == psid.chain.device
    assert rel(got, want) <= TOL_C128


@pytest.mark.gpu
def test_pipeline_chi_grid_direct_complex128_on_card(cuda_device, tmp_path):
    ks, ls = grid(9)
    _, psi = zt_operands("cpu")
    kw = dict(chi=128, dtype=torch.complex128, cache_dir=str(tmp_path))
    want = qt.ZTPipeline(N_BITS, device="cpu", **kw).chi_grid_direct(
        psi, ks, ls, wr=2 * math.pi)
    pipe = qt.ZTPipeline(N_BITS, device=cuda_device, **kw)
    before = rk.coefficient_batch_k1.launches
    got = pipe.chi_grid_direct(psi.to(cuda_device), ks.to(cuda_device),
                               ls.to(cuda_device), wr=2 * math.pi)
    assert rk.coefficient_batch_k1.launches == before
    assert rel(got, want) <= TOL_C128


@pytest.mark.gpu
def test_pole_search_direct_complex128_on_card(cuda_device, tmp_path):
    _, psi = zt_operands("cpu")
    kw = dict(coarse_points=32, fine_points=16, superfine_half=4,
              readout="direct", cache_dir=str(tmp_path))
    want = qt.coarse_to_fine_pole_search(psi, **kw)
    before = rk.coefficient_batch_k1.launches
    got = qt.coarse_to_fine_pole_search(psi.to(cuda_device), **kw)
    assert rk.coefficient_batch_k1.launches == before
    for scan in ("coarse", "fine", "superfine"):
        g, w = getattr(got, scan), getattr(want, scan)
        assert g.chi.dtype == torch.complex128
        assert rel(g.chi, w.chi) <= TOL_C128, scan
        assert (int(g.k_peak), int(g.l_peak)) == (int(w.k_peak), int(w.l_peak))


@pytest.mark.gpu
def test_spectrum_complex128_on_card(cuda_device):
    pipe = qt.QFTPipeline(N_BITS, chi=16, cutoff=1e-12,
                          dtype=torch.complex128, device="cpu")
    out = pipe.forward(pipe.encode(qt.generate_signal(
        N_BITS, dtype=torch.float64, device="cpu")))
    freqs = torch.arange(0, 2**N_BITS, 3)
    want = pipe.spectrum(out, freqs)
    before = rk.coefficient_batch_k1.launches
    got = pipe.spectrum(out.to(cuda_device), freqs.to(cuda_device))
    assert rk.coefficient_batch_k1.launches == before
    assert got.dtype == torch.complex128
    assert rel(got, want) <= TOL_C128


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_spectrum_wider_than_k1_on_card(cuda_device, dtype):
    # chi 264 > 256: the plain readout in the chain's own dtype; complex128
    # against the CPU within 1e-10, complex64 against the CPU's complex128
    # read of the same chain within K1's own bar (1e-5: float32 products)
    rng = np.random.default_rng(264)
    chain = random_chain(rng, 6, 264, "cpu", amplitude=1.5).to(dtype=dtype)
    pipe = object.__new__(qt.QFTPipeline)  # spectrum reads only n
    pipe.n = 6
    freqs = torch.arange(64)
    want = pipe.spectrum(chain.to(dtype=torch.complex128), freqs)
    before = rk.coefficient_batch_k1.launches
    got = pipe.spectrum(chain.to(cuda_device), freqs.to(cuda_device))
    assert rk.coefficient_batch_k1.launches == before
    assert got.dtype == dtype
    assert rel(got, want) <= (TOL_C128 if dtype == torch.complex128 else 1e-5)
