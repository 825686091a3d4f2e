"""Port containers, bits and artifacts against the JAX package (c128).

Inputs are random zero-padded chains made from a numpy seed; both packages
get the same arrays. Tolerance: relative 1e-12 (both sides run the same
f64 arithmetic up to summation order)."""

import numpy as np
import pytest
import torch

import qilaplace_tpu.core.mpo as jmpo
import qilaplace_tpu.core.mps as jmps
import qilaplace_tpu.signals.encode as jenc
from qilaplace_tpu.utils import bits as jbits
from qilaplace_tpu.utils import io as jio

import qilaplace_tpu_torch as qt
from qilaplace_tpu_torch.utils import bits as tbits
from qilaplace_tpu_torch.utils import io as tio

from port_helpers import random_cores, rel_err

REL = 1e-12


CHAINS = [
    (0, [1, 2, 3, 2, 1], None),
    (1, [1, 2, 4, 8, 5, 3, 2, 1], None),
    (2, [1, 2, 4, 4, 2, 1], 16),
]


@pytest.mark.parametrize("seed,ranks,chi", CHAINS)
def test_mps_from_core_list_repad_and_coefficients(seed, ranks, chi):
    rng = np.random.default_rng(seed)
    cores = random_cores(rng, ranks)
    amp = 1.7
    psi_j = jmps.MPS.from_core_list(cores, amplitude=amp, chi=chi)
    psi_t = qt.MPS.from_core_list(cores, amplitude=amp, chi=chi, device="cpu")
    assert psi_t.cores.shape == psi_j.cores.shape
    assert np.array_equal(psi_t.cores.numpy(), np.asarray(psi_j.cores))
    assert np.array_equal(psi_t.ranks.numpy(), np.asarray(psi_j.ranks))
    for a, b in zip(psi_t.to_core_list(), psi_j.to_core_list()):
        assert np.array_equal(a, b)
    qt.validate(psi_t)

    wide_t, wide_j = qt.repad(psi_t, 32), jmps.repad(psi_j, 32)
    assert np.array_equal(wide_t.cores.numpy(), np.asarray(wide_j.cores))
    tight = qt.repad(wide_t, 8)
    assert np.array_equal(tight.cores.numpy(),
                          np.asarray(jmps.repad(wide_j, 8).cores))
    qt.validate(tight)

    n = len(ranks) - 1
    configs = rng.integers(0, 2, (37, n))
    got = qt.coefficient_batch(psi_t, torch.from_numpy(configs)).numpy()
    want = np.asarray(jmps.coefficient_batch(psi_j, configs))
    assert rel_err(got, want) < REL
    one = qt.coefficient(psi_t, "".join(map(str, configs[3])))
    assert abs(complex(one) - want[3]) < REL * np.abs(want).max()


def test_validate_and_repad_reject_bad_chains():
    rng = np.random.default_rng(3)
    psi = qt.MPS.from_core_list(random_cores(rng, [1, 2, 3, 1]), chi=8,
                                device="cpu")
    bad = psi.cores.clone()
    bad[1, 5, 0, 0] = 1.0  # data outside the valid ranks[1] x ranks[2] block
    broken = qt.MPS(cores=bad, ranks=psi.ranks, amplitude=psi.amplitude)
    with pytest.raises(ValueError, match="nonzero padding"):
        qt.validate(broken)
    with pytest.raises(ValueError):
        jmps.validate(jmps.MPS(cores=bad.numpy(), ranks=psi.ranks.numpy(),
                               amplitude=np.float64(1.0)))
    with pytest.raises(ValueError, match="max rank"):
        qt.repad(psi, 2)
    with pytest.raises(ValueError, match="discard"):
        qt.repad(broken, 4)


@pytest.mark.parametrize("seed,ranks", [(4, [1, 3, 5, 2, 1]),
                                        (5, [1, 2, 4, 6, 4, 2, 1])])
def test_paired_mpo_containers(seed, ranks):
    rng = np.random.default_rng(seed)
    cores = random_cores(rng, ranks, phys=(2, 2))
    W_j = jmpo.PairedSiteMPO(chain=jmpo.MPO.from_core_list(cores))
    W_t = qt.PairedSiteMPO(chain=qt.MPO.from_core_list(cores, device="cpu"))
    assert np.array_equal(W_t.chain.cores.numpy(), np.asarray(W_j.chain.cores))
    assert qt.max_bond(W_t) == int(jmpo.max_bond(W_j))
    qt.validate(W_t)
    for chi in (16, 8):
        a = qt.mpo_repad(W_t, chi).chain
        b = jmpo.mpo_repad(W_j, chi).chain
        assert np.array_equal(a.cores.numpy(), np.asarray(b.cores))
        assert np.array_equal(a.ranks.numpy(), np.asarray(b.ranks))
    for a, b in zip(W_t.chain.to_core_list(), W_j.chain.to_core_list()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [3, 11, 30])
def test_paired_config_from_kl(n):
    rng = np.random.default_rng(n)
    ks = rng.integers(0, 2**n, 50)
    ls = rng.integers(0, 2**n, 50)
    got = tbits.paired_config_from_kl(ks, ls, n)
    assert got.dtype == torch.int32
    want = np.asarray(jbits.paired_config_from_kl(ks, ls, n))
    assert np.array_equal(got.numpy(), want)
    k, l = int(ks[0]), int(ls[0])
    assert tbits.interleave_bits(tbits.int_to_bits(k, n, order="lsb"),
                                 tbits.int_to_bits(l, n, order="lsb")) \
        == want[0].tolist()


def test_artifacts_load_in_both_packages(tmp_path):
    rng = np.random.default_rng(6)
    psi_t = qt.ZTMPS(chain=qt.MPS.from_core_list(
        random_cores(rng, [1, 2, 3, 2, 1]), amplitude=2.5, device="cpu"))
    W_t = qt.PairedSiteMPO(chain=qt.MPO.from_core_list(
        random_cores(rng, [1, 3, 4, 3, 1], phys=(2, 2)), device="cpu").to(
            dtype=torch.complex64))
    for obj in (psi_t, W_t):
        path = str(tmp_path / f"{type(obj).__name__}.npz")
        tio.save(path, obj)
        back_j = jio.load(path)
        assert type(back_j).__name__ == type(obj).__name__
        assert np.array_equal(np.asarray(back_j.chain.cores),
                              obj.chain.cores.numpy())
        path2 = str(tmp_path / f"{type(obj).__name__}_jax.npz")
        jio.save(path2, back_j)
        back_t = tio.load(path2, device="cpu")
        assert type(back_t) is type(obj)
        assert back_t.chain.cores.dtype == obj.chain.cores.dtype
        assert torch.equal(back_t.chain.cores, obj.chain.cores)
        assert torch.equal(back_t.chain.ranks, obj.chain.ranks)
    assert float(tio.load(str(tmp_path / "ZTMPS.npz"),
                          device="cpu").amplitude) == 2.5


def test_getitem_matches_jax():
    """``psi[b1, ..., bn]`` and ZTMPS indexing on an interleaved config,
    against the JAX package's (tests/test_mps.py's getitem sugar)."""
    x = np.random.default_rng(1).normal(size=16)
    psi_j = jenc.signal_mps(x, cutoff=0.0)
    psi_t = qt.signal_mps(torch.from_numpy(x), cutoff=0.0, device="cpu")
    got = complex(psi_t[0, 0, 1, 1])
    assert abs(got - complex(psi_j[0, 0, 1, 1])) <= REL
    assert abs(got - x[3]) <= 1e-12
    assert complex(psi_t[[0, 0, 1, 1]]) == got  # a list reads the same
    z_j = jenc.signal_ztmps(x, cutoff=1e-14)
    z_t = qt.signal_ztmps(torch.from_numpy(x), cutoff=1e-14, device="cpu")
    for j in (3, 10):
        bits = tbits.int_to_bits(j, 4)
        cfg = tuple(tbits.interleave_bits(bits, bits))  # |j>_main |j>_copy
        want = complex(z_j[cfg])
        assert abs(complex(z_t[cfg]) - want) <= REL
        assert abs(want - x[j]) <= 1e-10
    off = (1, 0, 0, 0, 0, 0, 0, 0)  # main and copy disagree: zero
    assert abs(complex(z_t[off])) <= 1e-12 and abs(complex(z_j[off])) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_empty_constructors_match_jax(dtype):
    """Zero cores, every bond rank 1 (tests/test_mps.py's
    test_empty_constructors), in both packages."""
    psi_t = qt.MPS.empty(5, dtype=dtype, device="cpu")
    psi_j = jmps.MPS.empty(5, dtype=str(dtype).removeprefix("torch."))
    qt.validate(psi_t)
    assert psi_t.cores.shape == psi_j.cores.shape == (5, 8, 2, 8)
    assert psi_t.dtype == dtype
    assert np.array_equal(psi_t.cores.numpy(), np.asarray(psi_j.cores))
    assert np.array_equal(psi_t.ranks.numpy(), np.asarray(psi_j.ranks))
    assert psi_t.ranks.dtype == torch.int32 and float(psi_t.amplitude) == 1.0
    zt_t = qt.ZTMPS.empty(4, chi=4, dtype=dtype, amplitude=2.0, device="cpu")
    zt_j = jmps.ZTMPS.empty(4, chi=4, dtype=str(dtype).removeprefix("torch."),
                            amplitude=2.0)
    qt.validate(zt_t)
    assert zt_t.n == 4 and zt_t.chain.n == 8 and zt_t.chain.chi == 4
    assert np.array_equal(zt_t.chain.cores.numpy(),
                          np.asarray(zt_j.chain.cores))
    assert np.array_equal(zt_t.chain.ranks.numpy(),
                          np.asarray(zt_j.chain.ranks))
    assert float(zt_t.amplitude) == float(zt_j.amplitude) == 2.0
    assert complex(zt_t[(0,) * 8]) == 0
    with pytest.raises(ValueError, match="n >= 1"):
        qt.MPS.empty(0, device="cpu")


def test_empty_raises_without_a_card():
    """No device: the card, and without one a RuntimeError, never the CPU
    (the card's side is in test_torch_tutorials_gpu.py)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qt.MPS.empty(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qt.ZTMPS.empty(3)
