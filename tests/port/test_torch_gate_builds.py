"""The port's gate-built DT, paired-QFT and zT operators against the JAX
package.

``build_dt_mpo``, ``build_paired_qft_mpo`` and ``build_zt_mpo`` at
n = 2 and 3, at cutoff 1e-14 (zips through the truncated SVD, the DT stack
folded as one chain) and 1e-9 (range-mode zips, the DT stack split into
Part 1 and Part 2 beside the QFT stack): the same ranks, and the dense
operators agree within 1e-10 of their largest entry (complex128, LAPACK on
both sides). The JAX package compiles each build once per (n, cutoff), so
the n = 3 comparisons are in the slow tier.
"""

import numpy as np
import pytest
import torch

import qilaplace_tpu as qj
from qilaplace_tpu.transforms.zt import build_paired_qft_mpo as j_pqft
import qilaplace_tpu_torch as qt
from qilaplace_tpu_torch.transforms.zt import build_paired_qft_mpo as t_pqft

WR = 0.75
BUILDERS = {
    "dt": (lambda n, c: qj.build_dt_mpo(n, WR, cutoff=c),
           lambda n, c: qt.build_dt_mpo(n, WR, cutoff=c, device="cpu")),
    "paired_qft": (lambda n, c: j_pqft(n, cutoff=c),
                   lambda n, c: t_pqft(n, cutoff=c, device="cpu")),
    "zt": (lambda n, c: qj.build_zt_mpo(n, WR, cutoff=c),
           lambda n, c: qt.build_zt_mpo(n, WR, cutoff=c, device="cpu")),
}
CASES = [pytest.param(b, n, c, id=f"{b}-n{n}-c{c:g}",
                      marks=[pytest.mark.slow] if n == 3 else [])
         for b in BUILDERS for n in (2, 3) for c in (1e-14, 1e-9)]


@pytest.mark.parametrize("builder,n,cutoff", CASES)
def test_gate_build_matches_jax(builder, n, cutoff):
    build_j, build_t = BUILDERS[builder]
    Wj, Wt = build_j(n, cutoff), build_t(n, cutoff)
    assert isinstance(Wt, qt.PairedSiteMPO)
    assert Wt.chain.cores.dtype == torch.complex128
    assert Wt.chain.chi == Wj.chain.chi
    assert Wt.chain.ranks.tolist() == np.asarray(Wj.chain.ranks).tolist()
    Dj = np.asarray(qj.mpo_to_dense(Wj))
    Dt = qt.mpo_to_dense(Wt).numpy()
    assert np.abs(Dt - Dj).max() <= 1e-10 * np.abs(Dj).max()


def test_n1_builds_match_jax():
    """The n = 1 special cases (no fold)."""
    for Wt, Wj in [
        (qt.build_dt_mpo(1, WR, device="cpu"), qj.build_dt_mpo(1, WR)),
        (t_pqft(1, device="cpu"), j_pqft(1)),
        (qt.build_zt_mpo(1, WR, device="cpu"), qj.build_zt_mpo(1, WR)),
    ]:
        assert Wt.chain.chi == Wj.chain.chi
        Dj = np.asarray(qj.mpo_to_dense(Wj))
        assert np.abs(qt.mpo_to_dense(Wt).numpy() - Dj).max() <= 1e-14


def test_zt_mpo_gate_engine_dispatches_to_the_build():
    W = qt.zt_mpo(2, WR, engine="gate", cutoff=1e-9, dtype=torch.complex128,
                  cache=False, device="cpu")
    ref = qt.build_zt_mpo(2, WR, cutoff=1e-9, maxdim=160, device="cpu")
    assert torch.equal(W.chain.cores, ref.chain.cores)
    with pytest.raises(ValueError, match="engine"):
        qt.zt_mpo(2, WR, engine="tree", cache=False, device="cpu")


@pytest.mark.parametrize("cutoff", [1e-14, 1e-9])
def test_zt_build_is_its_folds_then_its_fuse(cutoff):
    """build_zt_mpo is the factor folds then the fuse, called in turn (as
    chip_smoke.py times them): the same cores bit for bit."""
    from qilaplace_tpu_torch.transforms import zt

    # at n = 2 build_zt_mpo caps every bucket at bucket_for(4**2) = 16
    W_dt, W_qft = zt._build_factors_concurrent(
        2, WR, cutoff=cutoff, maxdim=128, chi_f=16, dtype=torch.complex128,
        chi_work_f=None, device=torch.device("cpu"))
    W = zt._fuse_factors(W_dt, W_qft, chi=16, cutoff=cutoff, maxdim=16)
    ref = qt.build_zt_mpo(2, WR, cutoff=cutoff, maxdim=128, device="cpu")
    assert W.chain.chi == ref.chain.chi == 16
    assert torch.equal(W.chain.ranks, ref.chain.ranks)
    assert torch.equal(W.chain.cores, ref.chain.cores)
