"""The port's public surface covers the JAX package's: every name of
``qilaplace_tpu.__all__`` exists in ``qilaplace_tpu_torch`` (and in its
``__all__``), and the small helpers that came with this surface (the
container aliases and index helpers, ``mpo_from_traced``, the bit
helpers) behave as the JAX package's do."""

import numpy as np
import pytest
import torch

import qilaplace_tpu as qj
from qilaplace_tpu.utils import bits as jbits
import qilaplace_tpu_torch as qt
from qilaplace_tpu_torch.utils import bits as tbits


@pytest.mark.parametrize("name", qj.__all__)
def test_jax_public_name_exists_in_the_port(name):
    assert name in qt.__all__
    assert getattr(qt, name) is not None


def test_aliases():
    assert qt.SignalMPS is qt.MPS
    assert qt.SingleSiteMPO is qt.MPO


@pytest.mark.parametrize("n", [1, 3])
def test_site_and_bond_indices(n):
    x = np.random.default_rng(0).normal(size=2**n)
    for paired in (False, True):
        enc_j = qj.signal_ztmps if paired else qj.signal_mps
        enc_t = qt.signal_ztmps if paired else qt.signal_mps
        psi_j, psi_t = enc_j(x), enc_t(x, device="cpu")
        assert qt.siteindices(psi_t) == qj.siteindices(psi_j)
        assert qt.bondindices(psi_t) == qj.bondindices(psi_j)
        with pytest.warns(DeprecationWarning):
            assert qt.nsite(psi_t) == n


def test_mpo_from_traced_stacks_on_the_cores_device():
    rng = np.random.default_rng(1)
    shapes = [(1, 2, 2, 3), (3, 2, 2, 2), (2, 2, 2, 1)]
    cores = [torch.from_numpy(rng.normal(size=s) + 1j * rng.normal(size=s))
             for s in shapes]
    W = qt.mpo_from_traced(cores)
    assert W.chi == 8 and W.ranks.tolist() == [1, 3, 2, 1]
    assert W.cores.device == cores[0].device
    for got, want in zip(W.to_core_list(), cores):
        assert np.array_equal(got, want.numpy())
    with pytest.raises(ValueError, match="boundary"):
        qt.mpo_from_traced(cores[1:])


@pytest.mark.parametrize("n", [1, 4, 7])
def test_bit_helpers_match_jax(n):
    for val in (0, 1, 2**n - 1, (5 * 2**n) // 7):
        for order in ("msb", "lsb"):
            bits = tbits.int_to_bits(val, n, order=order)
            assert tbits.bits_to_int(bits, order=order) == val
            assert tbits.int_to_paired_bits(val, n, order=order) == \
                jbits.int_to_paired_bits(val, n, order=order)
        assert tbits.bit_reverse(val, n) == jbits.bit_reverse(val, n)
    p = tbits.bit_reversal_permutation(n)
    assert np.array_equal(p, jbits.bit_reversal_permutation(n))
    assert np.array_equal(p[p], np.arange(2**n))
