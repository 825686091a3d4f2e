"""Signal generation and the dense encoders against the JAX package.

The encoders take the same float32 signals (numpy) in both packages. The
rsvd sketches differ (torch and JAX draw different numbers), so the
signals are ones whose bond spectra leave no singular value near the
rank decision: a sine at 37.3 cycles (rank 2 at every bond) and a random
rank-3 tensor train. Ranks must then agree exactly, and the decoded
vectors within 1e-5 of each other relative to max |x|.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qilaplace_tpu as qj
import qilaplace_tpu_torch as qt
import qilaplace_tpu_torch.ops.complexlinalg as tcl


def tt_signal(n, r, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(1, 2, r))
    for i in range(1, n):
        v = np.tensordot(v, rng.normal(size=(r, 2, r if i < n - 1 else 1)),
                         axes=[[-1], [0]])
    return v.reshape(-1).astype(np.float32)


def signal(name, n):
    if name == "sin37":
        return np.sin(2 * np.pi * 37.3 * np.arange(2**n) / 2**n).astype(
            np.float32)
    return tt_signal(n, 3, n)


def rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return np.abs(x - y).max() / np.abs(y).max()


KW = dict(cutoff=1e-9, maxdim=32, k=20, p=4, q=1)


@pytest.mark.parametrize("method", ["svd", "rsvd"])
@pytest.mark.parametrize("name", ["sin37", "tt3"])
@pytest.mark.parametrize("n", [6, 10])
def test_signal_mps_matches_jax(n, name, method):
    x = signal(name, n)
    pt = qt.signal_mps(x, method=method, device="cpu", **KW)
    pj = qj.signal_mps(x, method=method, **KW)
    assert pt.cores.dtype == torch.float32 and pt.chi == pj.chi
    assert pt.ranks.tolist() == np.asarray(pj.ranks).tolist()
    vt = qt.mps_to_vector(pt).numpy()
    assert rel(vt, np.asarray(qj.mps_to_vector(pj))) <= 1e-5
    assert rel(vt, x) <= 1e-5
    assert abs(float(pt.amplitude) - float(pj.amplitude)) <= 1e-5 * float(
        pj.amplitude)


@pytest.mark.parametrize("method", ["svd", "rsvd"])
def test_signal_ztmps_matches_jax(method):
    n = 7
    x = signal("tt3", n)
    pt = qt.signal_ztmps(x, method=method, device="cpu", **KW)
    pj = qj.signal_ztmps(x, method=method, **KW)
    assert pt.chain.ranks.tolist() == np.asarray(pj.chain.ranks).tolist()
    assert pt.chain.chi == pj.chain.chi
    vt = qt.mps_to_vector(pt).numpy()
    assert rel(vt, np.asarray(qj.mps_to_vector(pj))) <= 1e-5
    qt.validate(pt)


def test_rsvd_encode_on_the_device_route(monkeypatch):
    # the Jacobi route (K2's plain version here) against JAX's native one
    monkeypatch.setattr(tcl, "FORCE_DEVICE_PATH", True)
    n = 8
    x = signal("sin37", n)
    pt = qt.signal_mps(x, method="rsvd", device="cpu", **KW)
    pj = qj.signal_mps(x, method="rsvd", **KW)
    assert pt.ranks.tolist() == np.asarray(pj.ranks).tolist()
    assert rel(qt.mps_to_vector(pt).numpy(), x) <= 1e-5


@pytest.mark.parametrize("kind,kw", [
    ("sin", {}),
    ("sin", {"freq": [3.0, 7.0], "phase": 0.25}),
    ("multi_sin", {}),
    ("sin_decay", {"freq": 2.0, "decay_rate": 0.5}),
    ("multi_sin_exp", {}),
    ("abs_cos_power_p8", {}),
])
def test_generate_signal_matches_jax(kind, kw):
    n = 10
    got = qt.generate_signal(n, kind=kind, device="cpu", **kw)
    want = np.asarray(qj.generate_signal(n, kind=kind, dtype=jnp.float32,
                                         **kw))
    assert got.dtype == torch.float32 and got.shape == (2**n,)
    # float32 sin/exp/pow of float32 arguments: a few ulp apart at most
    assert rel(got.numpy(), want) <= 1e-5


def test_random_kinds_are_seeded():
    a = qt.generate_signal(6, kind="random", seed=3, device="cpu")
    b = qt.generate_signal(6, kind="random", seed=3, device="cpu")
    assert torch.equal(a, b) and a.shape == (64,)
    s = qt.generate_signal(6, kind="sin", noise_level=0.1, seed=1,
                           device="cpu")
    assert float((s - qt.generate_signal(6, device="cpu")).abs().max()) > 0


def test_encode_zero_fills_to_a_power_of_two():
    x = signal("sin37", 5)[:27]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pt = qt.signal_mps(x, method="svd", device="cpu", cutoff=1e-12)
    assert any("power of 2" in str(w.message) for w in caught)
    v = qt.mps_to_vector(pt).numpy()
    assert v.shape == (32,) and np.abs(v[27:]).max() <= 1e-6
    assert rel(v[:27], x) <= 1e-5
