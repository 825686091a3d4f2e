"""Kernel K1 on the card against its plain torch version.

Needs a CUDA card (marker ``gpu``; skips here without one) and imports no
JAX, so it also runs where only the port is installed:

    python -m pytest tests/port/test_torch_k1_gpu.py -m gpu --confcutdir=tests/port

Tolerance: max |kernel - plain(c128)| / max |plain(c128)| <= 1e-5 (fp32
accumulation over chi terms and n sites; about 1e-6 is expected at the
main-path shape)."""

import math

import numpy as np
import pytest
import torch

import qilaplace_tpu_torch as qt
from qilaplace_tpu_torch.ops import readout_kernels as rk
from qilaplace_tpu_torch.utils.bits import paired_config_from_kl

TOL = 1e-5


def random_chain(rng, n, chi, device):
    scale = 1.0 / math.sqrt(2 * chi)  # keeps |v| O(1) along the chain
    cores = (rng.normal(size=(n, chi, 2, chi))
             + 1j * rng.normal(size=(n, chi, 2, chi))) * scale
    return qt.MPS(
        cores=torch.from_numpy(cores.astype(np.complex64)).to(device),
        ranks=torch.full((n + 1,), chi, dtype=torch.int32, device=device),
        amplitude=torch.tensor(1.5, device=device),
    )


def rel_err(got, ref):
    return float((got.to(ref.dtype) - ref).abs().max() / ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("n,chi,B", [(5, 8, 5), (20, 32, 1000), (7, 1, 33),
                                     (9, 100, 65), (60, 256, 4096)])
def test_k1_kernel_matches_plain_version(cuda_device, n, chi, B):
    rng = np.random.default_rng(chi)
    chain = random_chain(rng, n, chi, cuda_device)
    cfg = torch.from_numpy(
        rng.integers(0, 2, (B, n)).astype(np.int32)).to(cuda_device)
    before = rk.coefficient_batch_k1.launches
    got = rk.coefficient_batch_k1(chain, cfg)
    torch.cuda.synchronize()
    assert rk.coefficient_batch_k1.launches == before + 1
    ref = rk.coefficient_batch_k1_reference(chain.to(dtype=torch.complex128),
                                            cfg)
    assert got.dtype == torch.complex64 and got.shape == (B,)
    assert rel_err(got, ref) <= TOL


@pytest.mark.gpu
def test_k1_kernel_rejects_what_it_does_not_take(cuda_device):
    rng = np.random.default_rng(0)
    chain = random_chain(rng, 4, 8, cuda_device)
    cfg = torch.zeros(3, 4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        rk.coefficient_batch_k1(chain.to(dtype=torch.complex128), cfg)
    with pytest.raises(TypeError):
        rk.coefficient_batch_k1(chain, cfg.long())
    with pytest.raises(TypeError):
        rk.coefficient_batch_k1(chain, cfg[:, :3])
    with pytest.raises(ValueError):
        rk.coefficient_batch_k1(random_chain(rng, 2, 264, cuda_device),
                                torch.zeros(1, 2, dtype=torch.int32,
                                            device=cuda_device))


@pytest.mark.gpu
def test_slice_on_card_matches_cpu(cuda_device, tmp_path):
    # n=8 slice on the card (c64, through K1) against the same slice on the
    # CPU in c128 (plain version); then the pole search's peaks
    from port_helpers import sin_decay

    n = 8
    psi = qt.tighten(qt.signal_ztmps_cross(sin_decay(n), cutoff=1e-12,
                                           device="cpu"))
    pack = qt.zt_product_pack(n, 2 * math.pi, cutoff=1e-12, maxdim=128)
    rng = np.random.default_rng(1)
    ks, ls = rng.integers(0, 2**n, 200), rng.integers(0, 2**n, 200)
    cpu = qt.direct_vals(
        qt.tighten(qt.mpo_from_pack(pack, device="cpu",
                                    dtype=torch.complex128)),
        psi, paired_config_from_kl(ks, ls, n))
    W = qt.tighten(qt.mpo_from_pack(pack, device=cuda_device))
    psi_d = psi.to(cuda_device, torch.float32)
    before = rk.coefficient_batch_k1.launches
    card = qt.direct_vals(W, psi_d, paired_config_from_kl(
        ks, ls, n, device=cuda_device))
    assert rk.coefficient_batch_k1.launches == before + 1
    assert rel_err(card.cpu(), cpu) <= TOL
    kw = dict(coarse_points=64, fine_points=32, superfine_half=4,
              readout="direct", cache_dir=str(tmp_path))
    res_c = qt.coarse_to_fine_pole_search(psi, **kw)
    res_d = qt.coarse_to_fine_pole_search(psi_d, **kw)
    assert int(res_d.superfine.k_peak) == int(res_c.superfine.k_peak)
    assert int(res_d.superfine.l_peak) == int(res_c.superfine.l_peak)
