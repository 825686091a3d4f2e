"""Readouts: zipper_chain / apply_coefficient_batch against the JAX package
(c128, rel 1e-12), kernel K1's plain version against the Pallas kernel in
interpret mode (the tests/test_pallas.py cases, c64, atol 1e-5 as there),
and the wrapper's routing (the kernel itself: test_torch_k1_gpu.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qilaplace_tpu import signal_mps, signal_ztmps
from qilaplace_tpu.core.mpo import MPO as JMPO, PairedSiteMPO as JPaired
from qilaplace_tpu.core.mps import MPS as JMPS, ZTMPS as JZTMPS
from qilaplace_tpu.ops.apply import (
    apply_coefficient_batch as j_apply_cb,
    zipper_chain as j_zipper,
)
from qilaplace_tpu.ops.pallas_kernels import coefficient_batch_pallas
from qilaplace_tpu.utils.bits import int_to_bits, paired_config_from_kl

import qilaplace_tpu_torch as qt
from qilaplace_tpu_torch.ops import readout_kernels as rk
from qilaplace_tpu_torch.utils.interop import mpo_from_numpy, mps_from_numpy

from port_helpers import random_cores, rel_err


def paired_pair(seed, n, w_ranks, p_ranks):
    """Random paired operator + state (2n chain sites), JAX and port."""
    rng = np.random.default_rng(seed)
    Wj = JPaired(chain=JMPO.from_core_list(
        random_cores(rng, w_ranks, phys=(2, 2))))
    pj = JZTMPS(chain=JMPS.from_core_list(random_cores(rng, p_ranks),
                                          amplitude=1.3))
    Wt = mpo_from_numpy(np.asarray(Wj.chain.cores), np.asarray(Wj.chain.ranks),
                        device="cpu")
    pt = mps_from_numpy(np.asarray(pj.chain.cores), np.asarray(pj.chain.ranks),
                        np.asarray(pj.chain.amplitude), paired=True,
                        device="cpu")
    cfg = rng.integers(0, 2, (41, 2 * n)).astype(np.int32)
    return Wj, pj, Wt, pt, cfg


PAIRS = [(0, 2, [1, 2, 3, 3, 1], [1, 2, 2, 2, 1]),
         (1, 3, [1, 3, 5, 6, 5, 3, 1], [1, 2, 3, 4, 3, 2, 1])]


@pytest.mark.parametrize("seed,n,w_ranks,p_ranks", PAIRS)
def test_zipper_chain_matches(seed, n, w_ranks, p_ranks):
    Wj, pj, Wt, pt, cfg = paired_pair(seed, n, w_ranks, p_ranks)
    Kj, Kt = j_zipper(Wj, pj), qt.zipper_chain(Wt, pt)
    assert np.array_equal(Kt.ranks.numpy(), np.asarray(Kj.ranks))
    assert rel_err(Kt.cores.numpy(), np.asarray(Kj.cores)) < 1e-12
    want = np.asarray(j_apply_cb(Wj, pj, cfg))
    got = rk.coefficient_batch_k1(Kt, torch.from_numpy(cfg)).numpy()
    assert rel_err(got, want) < 1e-12


@pytest.mark.parametrize("seed,n,w_ranks,p_ranks", PAIRS)
def test_apply_coefficient_batch_matches(seed, n, w_ranks, p_ranks):
    Wj, pj, Wt, pt, cfg = paired_pair(seed, n, w_ranks, p_ranks)
    want = np.asarray(j_apply_cb(Wj, pj, cfg))
    got = qt.apply_coefficient_batch(Wt, pt, torch.from_numpy(cfg)).numpy()
    assert rel_err(got, want) < 1e-12


def _port(psi):
    chain = psi.chain if isinstance(psi, JZTMPS) else psi
    return mps_from_numpy(np.asarray(chain.cores), np.asarray(chain.ranks),
                          np.asarray(chain.amplitude), device="cpu")


def _pallas_cases():
    """The three tests/test_pallas.py cases: (state, configs)."""
    n = 5
    x = np.random.default_rng(0).normal(size=2**n).astype(np.float32)
    psi = signal_mps(jnp.asarray(x), cutoff=1e-7, chi=8)
    yield psi, np.array([int_to_bits(j, n) for j in range(2**n)])
    n = 3
    rng = np.random.default_rng(1)
    x = rng.normal(size=2**n).astype(np.float32)
    zt = signal_ztmps(jnp.asarray(x), cutoff=1e-7, chi=8)
    ks = rng.integers(0, 2**n, size=300)
    ls = rng.integers(0, 2**n, size=300)
    yield zt, np.asarray(paired_config_from_kl(ks, ls, n))
    n = 4
    x = np.random.default_rng(2).normal(size=2**n).astype(np.float32)
    psi = signal_mps(jnp.asarray(x), cutoff=1e-7, chi=8)
    yield psi, np.array([int_to_bits(j, n) for j in range(5)])


@pytest.mark.parametrize("case", [0, 1, 2])
def test_k1_plain_matches_pallas_interpret(case):
    psi, cfg = list(_pallas_cases())[case]
    want = np.asarray(coefficient_batch_pallas(psi, cfg, interpret=True))
    chain = _port(psi).to(dtype=torch.complex64)
    cfg_t = torch.from_numpy(cfg.astype(np.int32))
    got = rk.coefficient_batch_k1_reference(chain, cfg_t).numpy()
    assert got.shape == want.shape
    assert np.allclose(got, want, atol=1e-5)


def test_k1_wrapper_routes_cpu_to_plain_version():
    rng = np.random.default_rng(7)
    chain = qt.MPS.from_core_list(random_cores(rng, [1, 4, 8, 8, 4, 1]),
                                  amplitude=0.7, device="cpu").to(
                                      dtype=torch.complex64)
    cfg = torch.from_numpy(rng.integers(0, 2, (9, 5)).astype(np.int32))
    before = rk.coefficient_batch_k1.launches
    got = rk.coefficient_batch_k1(chain, cfg)
    assert rk.coefficient_batch_k1.launches == before  # no kernel launched
    assert torch.equal(got, rk.coefficient_batch_k1_reference(chain, cfg))
    meta = qt.MPS(cores=chain.cores.to("meta"), ranks=chain.ranks,
                  amplitude=chain.amplitude)
    with pytest.raises(ValueError, match="unsupported device"):
        rk.coefficient_batch_k1(meta, cfg)
