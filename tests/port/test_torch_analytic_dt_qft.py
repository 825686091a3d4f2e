"""The analytic DT and QFT operators of the port against the JAX package.

Both are host numpy in f64 copied from the JAX package (the rail cross,
its pivots, the Schmidt-product compression, the host compression), so at
n = 4-8 the ranks are equal and the complex128 cores agree within 1e-12.
The QFT operator is also the bit-reversed unitary DFT.
"""

import numpy as np
import pytest
import torch

import qilaplace_tpu as qj
import qilaplace_tpu_torch as qt

NS = [4, 5, 6, 7, 8]


def same(Wt, Wj):
    mt, mj = getattr(Wt, "chain", Wt), getattr(Wj, "chain", Wj)
    assert mt.ranks.tolist() == np.asarray(mj.ranks).tolist()
    ct, cj = mt.cores.numpy(), np.asarray(mj.cores)
    assert ct.shape == cj.shape and ct.dtype == np.complex128
    assert np.abs(ct - cj).max() <= 1e-12


@pytest.mark.parametrize("n", NS)
def test_analytic_dt_mpo_matches_jax(n):
    wr = 2 * np.pi if n % 2 else 0.5
    Wt = qt.analytic_dt_mpo(n, wr, dtype=torch.complex128, device="cpu")
    assert isinstance(Wt, qt.PairedSiteMPO)
    same(Wt, qj.analytic_dt_mpo(n, wr, dtype=np.complex128))


@pytest.mark.parametrize("n", NS)
def test_analytic_qft_mpo_matches_jax(n):
    Wt = qt.analytic_qft_mpo(n, dtype=torch.complex128, device="cpu")
    assert isinstance(Wt, qt.MPO)
    same(Wt, qj.analytic_qft_mpo(n, dtype=np.complex128))


def test_analytic_qft_mpo_is_the_bit_reversed_dft():
    n = 5
    N = 2**n
    rev = [int(format(k, f"0{n}b")[::-1], 2) for k in range(N)]
    F = np.exp(-2j * np.pi * np.outer(np.arange(N), np.arange(N)) / N)
    D = qt.mpo_to_dense(qt.analytic_qft_mpo(n, dtype=torch.complex128,
                                            device="cpu")).numpy()
    assert np.abs(D - F[rev] / np.sqrt(N)).max() <= 1e-8


def test_analytic_dt_mpo_agrees_with_the_gate_build():
    """On the paired inputs |j>|j>, the DT operators of both engines act
    alike (cutoff 1e-14)."""
    n, wr = 3, 0.75
    Da = qt.mpo_to_dense(qt.analytic_dt_mpo(
        n, wr, cutoff=1e-14, dtype=torch.complex128, device="cpu")).numpy()
    Dg = qt.mpo_to_dense(qt.build_dt_mpo(n, wr, device="cpu")).numpy()
    paired = [int("".join(2 * b for b in format(j, f"0{n}b")), 2)
              for j in range(2**n)]
    assert np.abs(Da[:, paired] - Dg[:, paired]).max() <= 1e-6
