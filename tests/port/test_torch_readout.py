"""Readouts: zipper_chain / apply_coefficient_batch against the JAX package
(c128, rel 1e-12; c64, rel 1e-5), kernel K1's plain version against the
Pallas kernel in interpret mode (the tests/test_pallas.py cases, c64, atol
1e-5 as there), and the wrapper's routing (the kernel itself:
test_torch_k1_gpu.py). apply_coefficient_batch contracts each distinct
prefix of its configs once: its cases are the configs of a pole search's
grids (shared prefixes), random distinct rows, duplicated rows, one row
and a chain longer than one sort key, and its counters against the
prefixes counted here."""

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


def chain_pair(seed, sites, chi_w, chi_p, dtype=np.complex128):
    """Random paired operator + state of ``sites`` chain sites at bonds
    chi_w and chi_p, JAX and port, in ``dtype``."""
    rng = np.random.default_rng(seed)
    ranks = lambda chi: [1] + [chi] * (sites - 1) + [1]  # noqa: E731
    w = [c.astype(dtype) for c in random_cores(rng, ranks(chi_w),
                                               phys=(2, 2))]
    p = [c.astype(dtype) for c in random_cores(rng, ranks(chi_p))]
    Wj = JPaired(chain=JMPO.from_core_list(w))
    pj = JZTMPS(chain=JMPS.from_core_list(p, amplitude=1.3))
    Wt = mpo_from_numpy(np.asarray(Wj.chain.cores), np.asarray(Wj.chain.ranks),
                        device="cpu")
    pt = mps_from_numpy(np.asarray(pj.chain.cores), np.asarray(pj.chain.ranks),
                        np.asarray(pj.chain.amplitude), paired=True,
                        device="cpu")
    return Wj, pj, Wt, pt


def grid_configs(ks, ls, n):
    """int32 [len(ks) len(ls), 2n] configs of the ks x ls grid."""
    K, L = np.meshgrid(ks, ls, indexing="ij")
    return np.asarray(paired_config_from_kl(K.reshape(-1), L.reshape(-1), n),
                      dtype=np.int32)


def prefix_configs(case, n, rng):
    """Configs [B, 2n] of each sharing pattern."""
    N = 2**n
    if case == "coarse":  # the full plane at stride N / 16
        ks = np.arange(0, N, N // 16)
        return grid_configs(ks, ks, n)
    if case == "fine":  # a window at an odd k stride around a peak
        return grid_configs((37 + 5 * np.arange(-6, 7)) % N,
                            (90 + np.arange(-6, 7)) % N, n)
    if case == "distinct":
        rows = rng.choice(4**n, size=40, replace=False)
        return ((rows[:, None] >> np.arange(2 * n)) & 1).astype(np.int32)
    if case == "duplicated":
        cfg = rng.integers(0, 2, (9, 2 * n)).astype(np.int32)
        return cfg[rng.integers(0, 9, 40)]
    if case == "one":
        return rng.integers(0, 2, (1, 2 * n)).astype(np.int32)
    if case == "long":  # bits past one sort key decide the order
        cfg = np.zeros((48, 2 * n), dtype=np.int32)
        cfg[:, :3] = rng.integers(0, 2, (48, 3))
        cfg[:, -5:] = rng.integers(0, 2, (48, 5))
        return cfg
    raise ValueError(case)


def distinct_prefixes(cfg):
    """U_s for s = 1..n: distinct prefixes of sites 1..s, counted by set."""
    return [len({tuple(r[:s]) for r in cfg.tolist()})
            for s in range(1, cfg.shape[1] + 1)]


PREFIX_CASES = [  # case, register bits n, chi_w, chi_p, dtype
    ("coarse", 6, 3, 2, np.complex128),
    ("coarse", 6, 3, 2, np.complex64),
    ("fine", 7, 3, 2, np.complex128),
    ("distinct", 6, 3, 3, np.complex128),
    ("duplicated", 5, 2, 3, np.complex128),
    ("one", 5, 3, 2, np.complex128),
    ("long", 32, 2, 2, np.complex128),
]


@pytest.mark.parametrize("case,n,chi_w,chi_p,dtype", PREFIX_CASES)
def test_apply_coefficient_batch_shared_prefixes_match(case, n, chi_w, chi_p,
                                                       dtype):
    rng = np.random.default_rng(sum(map(ord, case)))
    Wj, pj, Wt, pt = chain_pair(n, 2 * n, chi_w, chi_p, dtype)
    cfg = prefix_configs(case, n, rng)
    want = np.asarray(j_apply_cb(Wj, pj, cfg))
    got = qt.apply_coefficient_batch(Wt, pt, torch.from_numpy(cfg)).numpy()
    assert got.dtype == want.dtype == dtype
    assert got.shape == (cfg.shape[0],)
    assert rel_err(got, want) < (1e-12 if dtype == np.complex128 else 1e-5)


def coarse_shared_row_sites(n, stride_bits):
    """Closed form of sum_s U_{s-1} on the full plane at stride
    2^stride_bits in k and l: sites 1..p hold k's lowest ceil(p/2) bits and
    l's lowest floor(p/2), of which only those at or above stride_bits
    vary."""
    free = lambda b: min(max(b - stride_bits, 0), n - stride_bits)  # noqa
    return sum(2 ** (free((p + 1) // 2) + free(p // 2)) for p in range(2 * n))


@pytest.mark.parametrize("case,n", [("coarse", 6), ("coarse", 8),
                                    ("fine", 7), ("distinct", 6),
                                    ("duplicated", 5), ("long", 32)])
def test_apply_coefficient_batch_counts_prefixes(case, n):
    from qilaplace_tpu_torch.ops.apply import _prefix_plan

    rng = np.random.default_rng(5)
    _, _, Wt, pt = chain_pair(1, 2 * n, 2, 2)
    cfg = prefix_configs(case, n, rng)
    U = distinct_prefixes(cfg)
    acb = qt.apply_coefficient_batch
    before = acb.row_sites, acb.shared_row_sites
    acb(Wt, pt, torch.from_numpy(cfg))
    assert acb.row_sites - before[0] == cfg.shape[0] * 2 * n
    assert acb.shared_row_sites - before[1] == 1 + sum(U[:-1])
    if case == "coarse":
        assert 1 + sum(U[:-1]) == coarse_shared_row_sites(n, n - 4)
    # the plan rebuilds every row: follow its final id back through parents
    counts, parent, bit, final = _prefix_plan(torch.from_numpy(cfg))
    assert counts == U
    at = np.cumsum([0] + U[:-1])
    rows = final.clone()
    for s in reversed(range(2 * n)):
        q = at[s] + rows
        assert torch.equal(bit[q], torch.from_numpy(cfg[:, s]).long())
        rows = parent[q]
    assert not rows.any()


def test_apply_coefficient_batch_rejects_configs_of_another_length():
    _, _, Wt, pt = chain_pair(2, 6, 2, 2)
    with pytest.raises(ValueError, match="configs have 5 sites"):
        qt.apply_coefficient_batch(Wt, pt,
                                   torch.zeros(3, 5, dtype=torch.int32))


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
