"""MPO apply / compose and the MPS sweeps against the JAX package.

Random operators and states (numpy, seeded) at n <= 6 go into both
packages as the same padded cores; results are compared densely through
``mpo_to_dense`` / ``mps_to_vector``. Complex128 on the native route:
exact within 1e-10. One float32-class case runs the port's device route
(the plain Jacobi solver), within 1e-4 of the exact product.
"""

import numpy as np
import pytest
import torch

import qilaplace_tpu as qj
import qilaplace_tpu.core.mpo as jmpo
import qilaplace_tpu.core.mps as jmps
import qilaplace_tpu.ops.apply as japp
import qilaplace_tpu_torch as qt
import qilaplace_tpu_torch.ops.apply as tapp
import qilaplace_tpu_torch.ops.complexlinalg as tcl
from port_helpers import random_cores


def pair(rng, ranks, phys, chi=None, scale=1.0):
    """The same random chain as a JAX and a port container."""
    cores = [c * scale for c in random_cores(rng, ranks, phys)]
    if phys == (2,):
        return (jmps.MPS.from_core_list(cores, chi=chi),
                qt.MPS.from_core_list(cores, chi=chi, device="cpu"))
    return (jmpo.MPO.from_core_list(cores, chi=chi),
            qt.MPO.from_core_list(cores, chi=chi, device="cpu"))


def rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return np.abs(x - y).max() / np.abs(y).max()


def dense_w(W):
    return qt.mpo_to_dense(W).numpy()


def vec(psi):
    return qt.mps_to_vector(psi).numpy()


@pytest.mark.parametrize("fused", [False, True])
def test_apply_matches_jax(fused):
    rng = np.random.default_rng(1)
    n = 5
    Wj, Wt = pair(rng, [1, 2, 3, 3, 2, 1], (2, 2), scale=0.5)
    pj, pt = pair(rng, [1, 2, 4, 4, 2, 1], (2,))
    kw = dict(maxdim=16, cutoff=1e-14) if fused else {}
    out_t = qt.apply(Wt, pt, **kw)
    out_j = qj.apply(Wj, pj, **kw)
    want = dense_w(Wt) @ vec(pt)
    assert rel(vec(out_t), want) <= 1e-10
    assert rel(vec(out_t), np.asarray(qj.mps_to_vector(out_j))) <= 1e-10
    if fused:
        assert out_t.ranks.tolist() == np.asarray(out_j.ranks).tolist()
    assert rel(vec(Wt * pt), want) <= 1e-10  # the * sugar applies


def test_fused_apply_on_the_device_route(monkeypatch):
    monkeypatch.setattr(tcl, "FORCE_DEVICE_PATH", True)
    rng = np.random.default_rng(2)
    _, Wt = pair(rng, [1, 2, 2, 2, 1], (2, 2), scale=0.5)
    _, pt = pair(rng, [1, 2, 3, 2, 1], (2,))
    Wt = Wt.to(dtype=torch.complex64)
    pt = pt.to(dtype=torch.complex64)
    out = qt.apply(Wt, pt, maxdim=8, cutoff=1e-9)
    want = dense_w(Wt).astype(np.complex128) @ vec(pt)
    assert rel(vec(out), want) <= 1e-4


def test_range_zip_matches_jax():
    # the cap-only range split in the zip, on the native route (on the
    # Jacobi route its 3-sweep eigensolve leaves noise directions of an
    # exactly low-rank zip matrix unconverged in either package)
    rng = np.random.default_rng(2)
    Wj, Wt = pair(rng, [1, 2, 2, 2, 1], (2, 2), scale=0.5)
    pj, pt = pair(rng, [1, 2, 3, 2, 1], (2,))
    out_t = qt.apply(Wt, pt, maxdim=8, cutoff=1e-9, zip_mode="range")
    out_j = qj.apply(Wj, pj, maxdim=8, cutoff=1e-9, zip_mode="range")
    want = dense_w(Wt) @ vec(pt)
    assert rel(vec(out_t), want) <= 1e-5
    assert out_t.ranks.tolist() == np.asarray(out_j.ranks).tolist()


@pytest.mark.parametrize("fused", [False, True])
def test_apply_mpo_mpo_matches_jax(fused):
    rng = np.random.default_rng(3)
    Aj, At = pair(rng, [1, 2, 3, 2, 1], (2, 2))
    Bj, Bt = pair(rng, [1, 3, 2, 2, 1], (2, 2))
    kw = dict(maxdim=16, cutoff=1e-14) if fused else {}
    Ct = qt.apply_mpo_mpo(At, Bt, **kw)
    Cj = qj.apply_mpo_mpo(Aj, Bj, **kw)
    want = dense_w(Bt) @ dense_w(At)  # A acts first
    assert rel(dense_w(Ct), want) <= 1e-10
    assert rel(dense_w(Ct), np.asarray(qj.mpo_to_dense(Cj))) <= 1e-10
    assert rel(dense_w(At * Bt), want) <= 1e-10  # W1 * W2 = W2 after W1


def test_apply_mpo_mpo_with_offset():
    rng = np.random.default_rng(4)
    Aj, At = pair(rng, [1, 2, 2, 2, 2, 1], (2, 2))
    Wj, Wt = pair(rng, [1, 3, 1], (2, 2))  # a 2-site window
    Ct = qt.apply_mpo_mpo(At, Wt, offset=2)
    Cj = qj.apply_mpo_mpo(Aj, Wj, offset=2)
    assert rel(dense_w(Ct), np.asarray(qj.mpo_to_dense(Cj))) <= 1e-10
    emb = qt.embed_window(Wt, 5, 2)
    want = np.kron(np.kron(np.eye(4), dense_w(Wt)), np.eye(2))
    assert rel(dense_w(emb), want) <= 1e-12
    with pytest.raises(ValueError):
        qt.apply_mpo_mpo(At, Wt)


def test_mpo_compress_matches_jax():
    rng = np.random.default_rng(5)
    Aj, At = pair(rng, [1, 2, 2, 2, 1], (2, 2))
    Bj, Bt = pair(rng, [1, 2, 2, 2, 1], (2, 2))
    # an exact product carries redundant bond (4 x 4 = 16 > the rank)
    Pt, Pj = qt.apply_mpo_mpo(At, Bt), qj.apply_mpo_mpo(Aj, Bj)
    Ct = qt.mpo_compress(Pt, cutoff=1e-14)
    Cj = japp.mpo_compress(Pj, cutoff=1e-14)
    assert Ct.ranks.tolist() == np.asarray(Cj.ranks).tolist()
    assert rel(dense_w(Ct), dense_w(Pt)) <= 1e-10


def test_compose_layers_and_pair_stack_match_jax():
    rng = np.random.default_rng(6)
    n = 4
    layers = [pair(rng, [1, 2, 2, 2, 1], (2, 2), chi=8) for _ in range(3)]
    acc_j = qj.identity_mpo(n, chi=16, dtype=np.complex128)
    acc_t = qt.identity_mpo(n, chi=16, dtype=torch.complex128, device="cpu")
    assert rel(dense_w(acc_t), np.eye(2**n)) <= 0
    lc_j, lr_j = japp.stack_layers([l[0] for l in layers])
    lc_t, lr_t = tapp.stack_layers([l[1] for l in layers])
    kw = dict(cutoff=1e-14, maxdim=16)
    out_j = japp.compose_layers(acc_j, lc_j, lr_j, **kw)
    out_t = qt.compose_layers(acc_t, lc_t, lr_t, **kw)
    want = np.eye(2**n)
    for _, Lt in layers:
        want = dense_w(Lt) @ want
    assert rel(dense_w(out_t), want) <= 1e-10
    assert out_t.ranks.tolist() == np.asarray(out_j.ranks).tolist()
    pc_t, pr_t = tapp.pair_layer_stack([l[1] for l in layers])
    pc_j, pr_j = japp.pair_layer_stack([l[0] for l in layers])
    assert pc_t.shape == pc_j.shape
    assert np.abs(pc_t.numpy() - np.asarray(pc_j)).max() <= 1e-12
    assert pr_t.tolist() == np.asarray(pr_j).tolist()


def test_sweeps_match_jax():
    rng = np.random.default_rng(7)
    # a rank-deficient state padded wider than its ranks
    pj, pt = pair(rng, [1, 2, 4, 4, 2, 1], (2,), chi=16)
    for direction in ("left", "right"):
        ct = qt.canonicalize(pt, direction)
        cj = qj.canonicalize(pj, direction)
        assert ct.ranks.tolist() == np.asarray(cj.ranks).tolist()
        assert rel(vec(ct), vec(pt)) <= 1e-10
    ct = qt.compress(pt, maxdim=3, tol=1e-12)
    cj = qj.compress(pj, maxdim=3, tol=1e-12)
    assert ct.ranks.tolist() == np.asarray(cj.ranks).tolist()
    assert rel(vec(ct), np.asarray(qj.mps_to_vector(cj))) <= 1e-10
    assert abs(float(qt.norm(ct)) - 1.0) <= 1e-12
    assert abs(float(qt.norm(pt)) - float(qj.norm(pj))) <= 1e-12
    rev = qt.mps_to_vector(pt, reverse=True).numpy()
    assert rel(rev, np.asarray(qj.mps_to_vector(pj, reverse=True))) <= 1e-12
