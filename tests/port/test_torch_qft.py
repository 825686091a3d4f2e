"""The QFT spectrum path of the port against the JAX package and the
closed form.

* the gate layers and the gate-built QFT operator at n <= 6: dense against
  the bit-reversed unitary DFT and against JAX (complex128, within 1e-10);
* the whole ``QFTPipeline`` at n = 8 (the ``sin`` signal, cutoff 1e-9,
  the default build) on the port's native route and on its forced device
  route (the Jacobi solver, K2's plain version), against the closed-form
  DFT of x_j = sin(j / N). Encoded by rsvd (k=50 p=5 q=2), a run is held to
  the closed form only: the rsvd sketch, not the port, decides the
  encoder's rank at the finest bonds, and torch and JAX draw different
  numbers. Through ``__call__`` (the TT-SVD encode, which draws nothing)
  the port is also held to the JAX package's ``__call__`` on the same
  route: within 1e-4 on the native route (LAPACK's SVD in complex64), and
  within the closed-form bar on the device route, where the float32 Gram
  eigensolve rounds otherwise in each package and the two runs differ by
  about the size of their own errors.
"""

import numpy as np
import pytest
import torch

import qilaplace_tpu as qj
from qilaplace_tpu.circuits import qft_gates as jg
from qilaplace_tpu.models.pipelines import QFTPipeline as JQFTPipeline
import qilaplace_tpu.ops.complexlinalg as jcl
import qilaplace_tpu_torch as qt
import qilaplace_tpu_torch.ops.complexlinalg as tcl
from qilaplace_tpu_torch.circuits import dt_gates, zt_gates
from qilaplace_tpu_torch.circuits import qft_gates as tg
from qilaplace_tpu_torch.ops.truncation import sketch_matrix
from qilaplace_tpu_torch.utils import interop, io

N_PIPE = 8
PIPE = dict(chi=16, cutoff=1e-9)
ENCODE = dict(method="rsvd", k=50, p=5, q=2)
FORCED_BAR = 2e-3
CALL_BAR = {"native": 1e-4, "device": FORCED_BAR}


def bit_reversed_dft(n):
    N = 2**n
    F = np.exp(-2j * np.pi * np.outer(np.arange(N), np.arange(N)) / N)
    rev = [int(format(k, f"0{n}b")[::-1], 2) for k in range(N)]
    return F[rev] / np.sqrt(N)


def sin_spectrum(n, ks):
    """Unitary DFT of x_j = sin(a j), a = 1/N, in closed form:
    X_k = N^-1/2 (G(a - 2 pi k/N) - G(-a - 2 pi k/N)) / 2i,
    G(t) = (1 - e^{i t N}) / (1 - e^{i t})."""
    N = 2**n
    a = 1.0 / N
    th = 2 * np.pi * np.asarray(ks, dtype=np.float64) / N

    def G(t):
        return (1 - np.exp(1j * t * N)) / (1 - np.exp(1j * t))

    return (G(a - th) - G(-a - th)) / (2j * np.sqrt(N))


def rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return np.abs(x - y).max() / np.abs(y).max()


@pytest.mark.parametrize("k", [1, 2, 4])
def test_control_hphase_layer_matches_jax(k):
    Wt = tg.control_Hphase_mpo(k, device="cpu")
    Wj = jg.control_Hphase_mpo(k)
    assert Wt.ranks.tolist() == np.asarray(Wj.ranks).tolist()
    assert rel(qt.mpo_to_dense(Wt).numpy(), np.asarray(qj.mpo_to_dense(Wj))) \
        <= 1e-14


@pytest.mark.parametrize("n", [1, 3, 5, 6])
def test_build_qft_mpo_is_the_bit_reversed_dft(n):
    Wt = qt.build_qft_mpo(n, device="cpu")
    Wj = qj.build_qft_mpo(n)
    D = qt.mpo_to_dense(Wt).numpy()
    # the build's cutoff 1e-14 (relative squared) allows ~sqrt(1e-14)
    assert rel(D, bit_reversed_dft(n)) <= 1e-6
    assert rel(D, np.asarray(qj.mpo_to_dense(Wj))) <= 1e-10
    assert Wt.ranks.tolist() == np.asarray(Wj.ranks).tolist()
    assert Wt.chi == Wj.chi


@pytest.fixture(scope="module")
def jax_pipelines():
    """The JAX package's ``__call__`` spectrum on its native route and on
    its device route (``FORCE_DEVICE_PATH``, the TPU's route: the lax.scan
    Jacobi solver). The package's jitted functions are traced once per
    shape, so the caches are cleared around the forced run."""
    import jax

    ks = np.arange(2**N_PIPE)

    def run():
        pipe = JQFTPipeline(N_PIPE, **PIPE)
        return np.asarray(pipe(qj.generate_signal(N_PIPE), ks))

    spectra = {"native": run()}
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcl, "FORCE_DEVICE_PATH", True)
        spectra["device"] = run()
    jax.clear_caches()
    return ks, spectra


@pytest.mark.parametrize("route", ["native", "device"])
def test_qft_pipeline_n8(jax_pipelines, monkeypatch, route):
    """The port's route against the closed form, and its ``__call__``
    against the JAX package's ``__call__`` on the same route."""
    monkeypatch.setattr(tcl, "FORCE_DEVICE_PATH", route == "device")
    ks, spectra = jax_pipelines
    got_j = spectra[route]
    want = sin_spectrum(N_PIPE, ks)
    pipe = qt.QFTPipeline(N_PIPE, device="cpu", **PIPE)
    x = qt.generate_signal(N_PIPE, device="cpu")
    psi = pipe.encode(x, **ENCODE)
    out = pipe.forward(psi)
    got = pipe.spectrum(out, torch.from_numpy(ks))
    assert got.dtype == torch.complex64 and got.shape == ks.shape
    assert rel(got.numpy().astype(np.complex128), want) <= FORCED_BAR
    assert 1 <= qt.max_bond(pipe.mpo) <= 8 and qt.max_bond(out) <= PIPE["chi"]
    assert pipe.spectrum(out, [3]).shape == (1,)
    # __call__: encode (TT-SVD by default), apply, read
    called = pipe(x, torch.from_numpy(ks)).numpy().astype(np.complex128)
    assert rel(called, want) <= FORCED_BAR
    assert rel(called, got_j.astype(np.complex128)) <= CALL_BAR[route]


ENTRY_POINTS = {
    "QFTPipeline": lambda: qt.QFTPipeline(4),
    "ZTPipeline": lambda: qt.ZTPipeline(4),
    "generate_signal": lambda: qt.generate_signal(4),
    "signal_mps": lambda: qt.signal_mps(np.ones(16)),
    "signal_ztmps": lambda: qt.signal_ztmps(np.ones(16)),
    "signal_mps_cross": lambda: qt.signal_mps_cross(np.ones(16)),
    "signal_ztmps_cross": lambda: qt.signal_ztmps_cross(np.ones(16)),
    "build_qft_mpo": lambda: qt.build_qft_mpo(4),
    "control_Hphase_mpo": lambda: tg.control_Hphase_mpo(2),
    "analytic_zt_mpo": lambda: qt.analytic_zt_mpo(4, 1.0),
    "zt_mpo": lambda: qt.zt_mpo(4, 1.0, cache=False),
    "identity_mpo": lambda: qt.identity_mpo(4),
    "MPS.from_core_list": lambda: qt.MPS.from_core_list([np.ones((1, 2, 1))]),
    "MPO.from_core_list": lambda: qt.MPO.from_core_list(
        [np.ones((1, 2, 2, 1))]),
    "load": lambda: qt.load("unused.npz"),
    "cached_mpo": lambda: io.cached_mpo("unused", None),
    "cached_zt_mpo": lambda: io.cached_zt_mpo(4, 1.0, cutoff=1e-12,
                                              maxdim=8),
    "mps_from_numpy": lambda: interop.mps_from_numpy(
        np.ones((1, 1, 2, 1)), [1, 1], 1.0),
    "mpo_from_numpy": lambda: interop.mpo_from_numpy(
        np.ones((1, 1, 2, 2, 1)), [1, 1]),
    "sketch_matrix": lambda: sketch_matrix(1, 4, 2, torch.float32),
    "DTPipeline": lambda: qt.DTPipeline(3, 1.0),
    "build_dt_mpo": lambda: qt.build_dt_mpo(3, 1.0),
    "build_paired_qft_mpo": lambda: qt.build_paired_qft_mpo(3),
    "build_zt_mpo": lambda: qt.build_zt_mpo(3, 1.0),
    "zt_mpo(engine='gate')": lambda: qt.zt_mpo(3, 1.0, engine="gate",
                                               cache=False),
    "analytic_dt_mpo": lambda: qt.analytic_dt_mpo(4, 1.0),
    "analytic_qft_mpo": lambda: qt.analytic_qft_mpo(4),
    "dampedH": lambda: dt_gates.dampedH(1.0),
    "control_damping_mpo": lambda: dt_gates.control_damping_mpo(3, 2, 1.0),
    "control_damping_copy_mpo": lambda: dt_gates.control_damping_copy_mpo(
        3, 2, 1.0),
    "control_Hphase_ztmps_mpo": lambda: zt_gates.control_Hphase_ztmps_mpo(2),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Without a card and without device="cpu", every entry point raises
    before it computes anything; nothing falls back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[entry]()
