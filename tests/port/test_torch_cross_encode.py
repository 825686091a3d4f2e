"""Cross-interpolation encode: the port against the JAX package.

Same host numpy code on both sides, so pivots and ranks are identical and
cores agree to 1e-12; the sin_decay states tighten to the 4-bucket."""

import numpy as np
import pytest
import torch

from qilaplace_tpu.scan.pole_scan import tighten as j_tighten
from qilaplace_tpu.signals.cross_encode import (
    signal_mps_cross as j_mps_cross,
    signal_ztmps_cross as j_ztmps_cross,
)

import qilaplace_tpu_torch as qt

from port_helpers import sin_decay

TOL = 1e-12


@pytest.mark.parametrize("n", [8, 10])
def test_ztmps_cross_matches(n):
    kw = dict(cutoff=1e-12, maxdim=128)
    pj = j_ztmps_cross(sin_decay(n), **kw)
    pt = qt.signal_ztmps_cross(sin_decay(n), device="cpu", **kw)
    assert pt.chain.cores.dtype == torch.float64
    assert np.array_equal(pt.chain.ranks.numpy(), np.asarray(pj.chain.ranks))
    assert np.abs(pt.chain.cores.numpy() - np.asarray(pj.chain.cores)).max() \
        <= TOL
    assert abs(float(pt.amplitude) - float(pj.amplitude)) <= TOL
    tj, tt = j_tighten(pj), qt.tighten(pt)
    assert tt.chain.chi == tj.chain.chi == 4
    assert np.array_equal(tt.chain.ranks.numpy(), np.asarray(tj.chain.ranks))
    qt.validate(tt)


def test_mps_cross_vector_keeps_dtype():
    n = 9
    x = sin_decay(n)(np.arange(2**n)).astype(np.float32)
    pj = j_mps_cross(x, cutoff=1e-10, maxdim=64)
    pt = qt.signal_mps_cross(x, cutoff=1e-10, maxdim=64, device="cpu")
    assert pt.cores.dtype == torch.float32
    assert np.array_equal(pt.ranks.numpy(), np.asarray(pj.ranks))
    assert np.array_equal(pt.cores.numpy(), np.asarray(pj.cores))
    assert abs(float(pt.amplitude) - float(pj.amplitude)) <= TOL
