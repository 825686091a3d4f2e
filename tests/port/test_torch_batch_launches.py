"""A batch of signals reaches the eigensolver in one call per factorization.

With ``complexlinalg.FORCE_DEVICE_PATH`` set, CPU tensors take the route a
CUDA tensor takes (``_device_eigh``: kernel K2 on the card, its plain
version here). Over ``batched_signal_mps`` and ``batched_qft_pipeline`` a
batch of 8 signals must make exactly the ``_device_eigh`` calls that one
signal makes, each with leading dimension 8, as ``jax.vmap`` over
``pallas_call`` gives one launch with the batch in its grid. The QFT case
runs at chi 40, where the apply's zip and polish take the sketched route
(80-row matrices, sketch width 56); there the counted calls solve with a
float64 ``torch.linalg.eigh`` in place of the plain Jacobi solver, which
changes the values but not which calls are made (the plain solver takes
minutes at these shapes on the CPU).

The sketched route's rank rule counts ||M||_F^2 as its total: a batch
whose matrices have very different norms must get each matrix's own
ranks, not ranks decided against the batch's summed mass.
"""

import numpy as np
import pytest
import torch

import qilaplace_tpu_torch as qt
import qilaplace_tpu_torch.ops.complexlinalg as tcl
import qilaplace_tpu_torch.ops.truncation as ttr
from qilaplace_tpu_torch.parallel import batched_qft_pipeline, batched_signal_mps
from qilaplace_tpu_torch.utils.bits import tensor_int_to_bits


def wide_eigh(H, *, sweeps=None):
    """float64 LAPACK in place of the plain Jacobi solver, cast back."""
    wide = torch.complex128 if H.is_complex() else torch.float64
    lam, V = torch.linalg.eigh(H.to(wide))
    return lam.to(H.real.dtype), V.to(H.dtype)


def counting(monkeypatch, solve):
    """The shape of every ``_device_eigh`` call on the forced device
    route, each solved by ``solve``."""
    calls = []

    def counted(H, **kw):
        calls.append(tuple(H.shape))
        return solve(H, **kw)

    monkeypatch.setattr(tcl, "_device_eigh", counted)
    monkeypatch.setattr(ttr, "_device_eigh", counted)
    monkeypatch.setattr(tcl, "FORCE_DEVICE_PATH", True)
    return calls


@pytest.fixture
def eigh_calls(monkeypatch):
    return counting(monkeypatch, tcl._device_eigh)


@pytest.fixture
def wide_eigh_calls(monkeypatch):
    return counting(monkeypatch, wide_eigh)


def signals(B, n, seed=0):
    rng = np.random.default_rng(seed)
    j = np.arange(2**n)
    rows = [np.sin((b + 1) * 2.3 * j / 2**n) + 0.1 * rng.normal(size=2**n)
            for b in range(B)]
    return torch.from_numpy(np.stack(rows).astype(np.float32))


def calls_of(eigh_calls, fn):
    del eigh_calls[:]
    fn()
    return list(eigh_calls)


@pytest.mark.parametrize("method", ["svd", "rsvd"])
def test_batched_encode_is_one_call_per_factorization(eigh_calls, method):
    n, kw = 8, dict(chi=16, cutoff=1e-9, method=method)
    xs = signals(8, n)
    one = calls_of(eigh_calls, lambda: qt.signal_mps(
        xs[0], device="cpu", **kw))
    b1 = calls_of(eigh_calls, lambda: batched_signal_mps(
        xs[:1], device="cpu", **kw))
    b8 = calls_of(eigh_calls, lambda: batched_signal_mps(
        xs, device="cpu", **kw))
    assert len(one) == len(b1) == len(b8) > 0
    assert all(sh[:-2] == (1,) for sh in b1)
    assert all(sh[:-2] == (8,) for sh in b8)
    assert [sh[-1] for sh in b8] == [sh[-1] for sh in one]


def test_batched_qft_is_one_call_per_factorization(wide_eigh_calls):
    eigh_calls = wide_eigh_calls
    n, chi = 6, 40
    tcl.FORCE_DEVICE_PATH = False
    W = qt.build_qft_mpo(n, cutoff=1e-9, dtype=torch.complex64, device="cpu")
    tcl.FORCE_DEVICE_PATH = True
    configs = tensor_int_to_bits(torch.arange(2**n), n, order="lsb")
    xs = signals(8, n, seed=1)
    run = lambda x: batched_qft_pipeline(  # noqa: E731
        W, x, configs, chi=chi, cutoff=1e-9, device="cpu")
    out = []
    b1 = calls_of(eigh_calls, lambda: out.append(run(xs[:1])))
    b8 = calls_of(eigh_calls, lambda: out.append(run(xs)))
    assert len(b1) == len(b8) > 0
    assert all(sh[:-2] == (8,) for sh in b8)
    assert [sh[-1] for sh in b8] == [sh[-1] for sh in b1]
    # the sketched route ran: Gram matrices of the sketch width (56 for
    # maxdim 40), not of the 80-row zip matrices
    assert 56 in {sh[-1] for sh in b8}
    # the batch's first row is the one-signal batch's row
    err = (out[1][0] - out[0][0]).abs().max() / out[0][0].abs().max()
    assert float(err) <= 1e-5


def test_sketched_total_is_per_matrix(monkeypatch):
    monkeypatch.setattr(tcl, "FORCE_DEVICE_PATH", True)
    rng = np.random.default_rng(3)
    a, b, k = 128, 256, 128
    s = 10.0 ** (-np.arange(k) / 4.0)
    Ms = []
    for scale in (1.0, 1e-4):
        U, _ = np.linalg.qr(rng.normal(size=(a, k)))
        V, _ = np.linalg.qr(rng.normal(size=(b, k)))
        Ms.append(scale * (U * s) @ V.T)
    M = torch.from_numpy(np.stack(Ms))
    kw = dict(cutoff=1e-6, maxdim=32)
    # on the sketched route: k = 128 > max(64, 5 l / 4), l = 40
    assert min(a, b) > max(64, (5 * 40) // 4)
    _, _, _, ranks = ttr.truncated_svd(M, **kw)
    alone = [int(ttr.truncated_svd(m, **kw)[3]) for m in M]
    assert ranks.tolist() == alone
    assert alone[0] == alone[1] > 1  # the same spectrum up to scale
