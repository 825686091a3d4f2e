"""The gate-built zT operator on the card's factorization route, on the
CPU.

``FORCE_DEVICE_PATH`` sends every eigensolve of a CPU tensor to the plain
Jacobi solver (K2's plain version), as the card's route sends it to K2.
In complex64 at n = 3, cutoff 1e-9 (range-mode zips, the split DT stack),
the zT grid of a seeded random signal lies within 1e-4 of its largest
entry of the closed form.
"""

import sys
from pathlib import Path

import numpy as np
import torch

import qilaplace_tpu_torch as qt
import qilaplace_tpu_torch.ops.complexlinalg as tcl

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from helpers import analytical_zt, paired_vector_to_grid  # noqa: E402


def test_zt_on_the_device_route_in_complex64(monkeypatch):
    monkeypatch.setattr(tcl, "FORCE_DEVICE_PATH", True)
    n, wr = 3, 0.75
    x = np.random.default_rng(3).normal(size=2**n)
    W = qt.build_zt_mpo(n, wr, cutoff=1e-9, dtype=torch.complex64,
                        device="cpu")
    assert W.chain.cores.dtype == torch.complex64
    out = qt.apply(W, qt.signal_ztmps(x.astype(np.float32), cutoff=1e-9,
                                      device="cpu"))
    Z = paired_vector_to_grid(qt.mps_to_vector(out).numpy(), n)
    Z_ref = analytical_zt(x, wr)
    assert np.abs(Z - Z_ref).max() <= 1e-4 * np.abs(Z_ref).max()
