"""Kernel K1 on the card against its plain torch version.

Needs a CUDA card (marker ``gpu``; skips here without one) and imports no
JAX, so it also runs where only the port is installed:

    python -m pytest tests/port/test_torch_k1_gpu.py -m gpu --confcutdir=tests/port

Tolerance: max |kernel - plain(c128)| / max |plain(c128)| <= 1e-5 (fp32
accumulation over chi terms and n sites; about 1e-6 is expected at the
main-path shape). The kernel's arithmetic depends only on the live widths
and the bits, so extra dead lanes leave its outputs bit-identical."""

import math

import numpy as np
import pytest
import torch

import qilaplace_tpu_torch as qt
from qilaplace_tpu_torch.ops import readout_kernels as rk
from qilaplace_tpu_torch.utils.bits import paired_config_from_kl

from port_helpers import RAGGED, embed, ragged_chain, random_chain

TOL = 1e-5


def rel_err(got, ref):
    return float((got.to(ref.dtype) - ref).abs().max() / ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("n,chi,B", [(5, 8, 5), (20, 32, 1000), (7, 1, 33),
                                     (9, 100, 65), (60, 256, 4096)])
def test_k1_kernel_matches_plain_version(cuda_device, n, chi, B):
    rng = np.random.default_rng(chi)
    chain = random_chain(rng, n, chi, cuda_device, amplitude=1.5)
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
@pytest.mark.parametrize("shape", sorted(RAGGED))
@pytest.mark.parametrize("B", [1, 33, 4097])
def test_k1_ragged_ranks(cuda_device, shape, B):
    n, chi, ranks, dead = RAGGED[shape]
    rng = np.random.default_rng(B + chi)
    chain = ragged_chain(rng, n, chi, ranks, dead, cuda_device)
    cfg = torch.from_numpy(
        rng.integers(0, 2, (B, n)).astype(np.int32)).to(cuda_device)
    got = rk.coefficient_batch_k1(chain, cfg)
    torch.cuda.synchronize()
    ref = rk.coefficient_batch_k1_reference(chain.to(dtype=torch.complex128),
                                            cfg)
    assert rel_err(got, ref) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("bit", [0, 1])
def test_k1_all_rows_one_branch(cuda_device, bit):
    n, chi, ranks, dead = RAGGED["off-tile"]
    rng = np.random.default_rng(bit)
    chain = ragged_chain(rng, n, chi, ranks, dead, cuda_device)
    cfg = torch.full((100, n), bit, dtype=torch.int32, device=cuda_device)
    got = rk.coefficient_batch_k1(chain, cfg)
    torch.cuda.synchronize()
    ref = rk.coefficient_batch_k1_reference(chain.to(dtype=torch.complex128),
                                            cfg)
    assert torch.equal(got, got[:1].expand(100))  # one value, every row
    assert rel_err(got, ref) <= TOL


@pytest.mark.gpu
def test_k1_dead_lanes_leave_outputs_bit_identical(cuda_device):
    rng = np.random.default_rng(128)
    chain = ragged_chain(rng, 10, 128, [1, 4, 16, 60, 128, 100, 128, 77, 30,
                                        4, 1], {5: 64}, cuda_device)
    big = embed(chain, 256, rng)
    cfg = torch.from_numpy(
        rng.integers(0, 2, (999, 10)).astype(np.int32)).to(cuda_device)
    base = rk.coefficient_batch_k1(chain, cfg)
    got = rk.coefficient_batch_k1(big, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, base)
    ref = rk.coefficient_batch_k1_reference(chain.to(dtype=torch.complex128),
                                            cfg)
    assert rel_err(got, ref) <= TOL


@pytest.mark.gpu
def test_k1_kernel_rejects_what_it_does_not_take(cuda_device):
    rng = np.random.default_rng(0)
    chain = random_chain(rng, 4, 8, cuda_device, amplitude=1.5)
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
