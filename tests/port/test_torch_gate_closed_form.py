"""The port's gate-built DT and zT operators against their closed forms.

The port alone, on the bars of the JAX package's own tests
(tests/test_dt.py, tests/test_zt.py), complex128 at cutoff 1e-14:

* DT on every basis state up to n = 4: the main register (LSB-first) of
  the copy-projected output equals (1/sqrt N) e^{-wr k j / N} within
  1e-7 (relative to max(1, ||ref||));
* zT on every basis state up to n = 3 within 2e-7, and on a seeded random
  signal at n = 4 within 1e-6 (slow tier: one n = 4 build takes about 30 s
  on one core).
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest

import qilaplace_tpu_torch as qt
from qilaplace_tpu_torch.utils.bits import int_to_bits

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from helpers import (  # noqa: E402
    analytical_dt,
    analytical_zt,
    basis_state,
    paired_vector_to_grid,
)


@functools.lru_cache(maxsize=None)
def dt_op(n, wr):
    return qt.build_dt_mpo(n, wr, cutoff=1e-14, device="cpu")


@functools.lru_cache(maxsize=None)
def zt_op(n, wr):
    return qt.build_zt_mpo(n, wr, cutoff=1e-14, device="cpu")


def encode(x):
    return qt.signal_ztmps(x, cutoff=1e-14, device="cpu")


def dt_main_vector(psi_out, copy_bits, n):
    """Project the copy register onto ``copy_bits`` and read the main
    register LSB-first (the DT output convention)."""
    arr = qt.mps_to_vector(psi_out).numpy().reshape((2,) * (2 * n))
    idx = []
    for b in copy_bits:
        idx += [slice(None), b]
    sub = arr[tuple(idx)]
    return np.array([sub[tuple(int_to_bits(k, n, order="lsb"))]
                     for k in range(2**n)])


@pytest.mark.parametrize("n,wr", [(1, 0.75), (2, 0.0), (2, 5.0), (3, 1.0),
                                  (4, 2.0)])
def test_dt_on_basis_states(n, wr):
    W = dt_op(n, wr)
    for j in range(2**n):
        x = basis_state(j, n)
        got = dt_main_vector(qt.apply(W, encode(x)), int_to_bits(j, n), n)
        want = analytical_dt(x, wr)
        assert np.linalg.norm(got - want) <= 1e-7 * max(
            1.0, np.linalg.norm(want))


@pytest.mark.parametrize("n,wr", [(1, 0.75), (2, 0.0), (2, 2.0), (3, 0.75)])
def test_zt_on_basis_states(n, wr):
    W = zt_op(n, wr)
    for j in range(2**n):
        x = basis_state(j, n)
        out = qt.apply(W, encode(x))
        Z = paired_vector_to_grid(qt.mps_to_vector(out).numpy(), n)
        assert np.linalg.norm(Z - analytical_zt(x, wr)) <= 2e-7


@pytest.mark.slow
def test_zt_n4_random_signal():
    n, wr = 4, 0.75
    x = np.random.default_rng(11).normal(size=2**n)
    out = qt.apply(zt_op(n, wr), encode(x))
    Z = paired_vector_to_grid(qt.mps_to_vector(out).numpy(), n)
    Z_ref = analytical_zt(x, wr)
    assert np.linalg.norm(Z - Z_ref) <= 1e-6 * max(1.0,
                                                   np.linalg.norm(Z_ref))
