"""The DT and zT gate tensors of the port against the JAX package.

Every block of ``circuits/dt_gates.py`` and ``circuits/zt_gates.py`` for
n <= 4, every k and wr in {0, 0.75, 2 pi}: the same ranks and chain cores
within 1e-14 in complex128. In complex64 the damping factors are evaluated
in float64 and cast last, as the JAX package does in x64, so the cores are
bit-identical.
"""

import numpy as np
import pytest
import torch

from qilaplace_tpu.circuits import dt_gates as jdt
from qilaplace_tpu.circuits import zt_gates as jzt
from qilaplace_tpu_torch.circuits import dt_gates as tdt
from qilaplace_tpu_torch.circuits import zt_gates as tzt

WRS = [0.0, 0.75, 2 * np.pi]
NK = [(n, k) for n in range(1, 5) for k in range(1, n + 1)]


def same_chain(Wt, Wj, tol):
    """Ranks equal, cores within ``tol`` (max abs), shapes equal."""
    ct, cj = Wt.chain.cores.numpy(), np.asarray(Wj.chain.cores)
    assert ct.shape == cj.shape
    assert Wt.chain.ranks.tolist() == np.asarray(Wj.chain.ranks).tolist()
    assert np.abs(ct - cj).max() <= tol


@pytest.mark.parametrize("wr", WRS)
def test_damped_hadamard_and_rotation(wr):
    for name in ("dampedH", "R"):
        got = getattr(tdt, name)(wr, device="cpu").numpy()
        want = np.asarray(getattr(jdt, name)(wr))
        assert got.dtype == np.complex128
        assert np.abs(got - want).max() <= 1e-14, name


@pytest.mark.parametrize("wr", WRS)
@pytest.mark.parametrize("n,k", NK)
def test_control_damping_mpo(n, k, wr):
    same_chain(tdt.control_damping_mpo(n, k, wr, device="cpu"),
               jdt.control_damping_mpo(n, k, wr), 1e-14)


@pytest.mark.parametrize("wr", WRS)
@pytest.mark.parametrize("n,k", NK)
def test_control_damping_copy_mpo(n, k, wr):
    same_chain(tdt.control_damping_copy_mpo(n, k, wr, device="cpu"),
               jdt.control_damping_copy_mpo(n, k, wr), 1e-14)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_control_hphase_ztmps_mpo(k):
    same_chain(tzt.control_Hphase_ztmps_mpo(k, device="cpu"),
               jzt.control_Hphase_ztmps_mpo(k), 1e-14)


@pytest.mark.parametrize("n,k", [(4, 1), (4, 3), (4, 4)])
def test_complex64_gates_are_bit_identical(n, k):
    """The damping exponentials are taken in float64 and cast last."""
    wr = 0.75
    for name in ("control_damping_mpo", "control_damping_copy_mpo"):
        Wt = getattr(tdt, name)(n, k, wr, dtype=torch.complex64,
                                device="cpu")
        Wj = getattr(jdt, name)(n, k, wr, dtype=np.complex64)
        assert Wt.chain.cores.dtype == torch.complex64
        same_chain(Wt, Wj, 0.0)
    same_chain(tzt.control_Hphase_ztmps_mpo(k, dtype=torch.complex64,
                                            device="cpu"),
               jzt.control_Hphase_ztmps_mpo(k, dtype=np.complex64), 0.0)


def test_gate_arguments_are_checked():
    with pytest.raises(ValueError):
        tdt.control_damping_mpo(3, 0, 1.0, device="cpu")
    with pytest.raises(ValueError):
        tdt.control_damping_copy_mpo(3, 4, 1.0, device="cpu")
    with pytest.raises(ValueError):
        tzt.control_Hphase_ztmps_mpo(0, device="cpu")
