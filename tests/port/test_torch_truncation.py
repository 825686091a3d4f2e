"""Truncated factorizations of the port against the JAX package's.

Both packages run their device route (``FORCE_DEVICE_PATH`` set on both
sides: the Jacobi eigensolver instead of LAPACK), and the native route,
on the same low-rank and zero-padded inputs made with numpy from a seed.
The sketches differ (torch and JAX draw different numbers), so the tests
compare what the sketch does not decide: singular values above the noise,
ranks, projectors and reconstructions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qilaplace_tpu.ops.complexlinalg as jcl
import qilaplace_tpu.ops.rsvd as jrs
import qilaplace_tpu.ops.truncation as jtr
import qilaplace_tpu_torch.ops.complexlinalg as tcl
import qilaplace_tpu_torch.ops.rsvd as trs
import qilaplace_tpu_torch.ops.truncation as ttr


@pytest.fixture
def device_route(monkeypatch):
    monkeypatch.setattr(jcl, "FORCE_DEVICE_PATH", True)
    monkeypatch.setattr(tcl, "FORCE_DEVICE_PATH", True)


def low_rank(seed, a, b, rank, dtype=np.complex64, pad=None, decay=0.5):
    """a x b matrix of ``rank`` with singular values decay**i, zero-padded
    to ``pad`` = (A, B) when given."""
    rng = np.random.default_rng(seed)
    cplx = np.iscomplexobj(np.zeros(1, dtype))

    def gauss(*s):
        return rng.normal(size=s) + (1j * rng.normal(size=s) if cplx else 0)

    U, _ = np.linalg.qr(gauss(a, rank))
    V, _ = np.linalg.qr(gauss(b, rank))
    M = (U * decay ** np.arange(rank)) @ np.conj(V.T)
    if pad is not None:
        P = np.zeros(pad, dtype=M.dtype)
        P[:a, :b] = M
        M = P
    return M.astype(dtype)


def rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return np.abs(x - y).max() / max(np.abs(y).max(), 1e-30)


def projector(Q, rank):
    Q = np.asarray(Q)[:, : int(rank)].astype(np.complex128)
    return Q @ np.conj(Q.T)


@pytest.mark.parametrize("pad", [None, (48, 40)])
def test_ceigh_and_gram_orthonormalize(device_route, pad):
    Y = low_rank(1, 32, 24, 6, pad=pad)
    G = np.conj(Y.T) @ Y
    lam_t, V_t = tcl.ceigh(torch.from_numpy(G))
    lam_j, _ = jcl.ceigh(jnp.asarray(G))
    assert rel(lam_t.numpy(), lam_j) <= 1e-5
    Q_t, r_t = tcl.gram_orthonormalize(torch.from_numpy(Y))
    Q_j, r_j = jcl.gram_orthonormalize(jnp.asarray(Y))
    assert int(r_t) == int(r_j) == 6
    assert np.abs(Q_t.numpy()[:, 6:]).max() == 0.0  # masked exactly
    P_t = projector(Q_t.numpy(), r_t)
    assert np.abs(P_t - projector(Q_j, r_j)).max() <= 1e-5
    assert np.abs(P_t @ Y - Y).max() / np.abs(Y).max() <= 1e-5


@pytest.mark.parametrize("shape", [(24, 40), (40, 24)])
def test_gram_svd(device_route, shape):
    M = low_rank(2, *shape, 8)
    U_t, s_t, Vh_t = ttr._gram_svd(torch.from_numpy(M), sweeps=6)
    _, s_j, _ = jtr._gram_svd(jnp.asarray(M), sweeps=6)
    assert rel(s_t.numpy()[:8], np.asarray(s_j)[:8]) <= 1e-5
    rec = (U_t * s_t.to(U_t.dtype)) @ Vh_t
    assert rel(rec.numpy(), M) <= 1e-5


# (shape, dtype, cutoff, maxdim): the fast profile and the tight float32
# profile on the sketched route (k = 128 > max(64, 5 l / 4)) and on the
# complete-Gram route, and the tight float64 profile
PROFILES = [
    ((128, 128), np.complex64, 1e-9, 16),
    ((128, 128), np.complex64, 1e-14, 16),
    ((40, 24), np.complex64, 1e-9, 24),
    ((24, 40), np.float32, 1e-14, 24),
    ((24, 40), np.complex128, 1e-14, 24),
]


@pytest.mark.parametrize("shape,dtype,cutoff,maxdim", PROFILES)
def test_truncated_svd_profiles(device_route, shape, dtype, cutoff, maxdim):
    a, b = shape
    M = low_rank(3, a - 8, b - 8, 7, dtype=dtype, pad=shape)
    U_t, s_t, Vh_t, r_t = ttr.truncated_svd(torch.from_numpy(M), cutoff=cutoff,
                                            maxdim=maxdim)
    _, s_j, _, r_j = jtr.truncated_svd(jnp.asarray(M), cutoff=cutoff,
                                       maxdim=maxdim)
    assert int(r_t) == int(r_j)
    r = int(r_t)
    tol = 1e-12 if dtype == np.complex128 else 1e-5
    assert rel(s_t.numpy()[:r], np.asarray(s_j)[:r]) <= tol
    assert np.all(s_t.numpy()[r:] == 0)
    rec = (U_t * s_t.to(U_t.dtype)) @ Vh_t
    # what the cutoff discards: 0.5**r of s_max at most, relative
    assert rel(rec.numpy(), M) <= max(tol, 2 * 0.5**r)


def test_truncated_svd_native_route_matches():
    M = low_rank(4, 30, 20, 9, dtype=np.complex128, pad=(36, 28))
    _, s_t, _, r_t = ttr.truncated_svd(torch.from_numpy(M), cutoff=1e-6)
    _, s_j, _, r_j = jtr.truncated_svd(jnp.asarray(M), cutoff=1e-6)
    assert int(r_t) == int(r_j)
    assert rel(s_t.numpy(), s_j) <= 1e-12


@pytest.mark.parametrize("absorb", ["left", "right", "both"])
def test_svd_split(device_route, absorb):
    M = low_rank(5, 32, 16, 5, pad=(40, 24))
    L_t, R_t, r_t = ttr.svd_split(torch.from_numpy(M), cutoff=1e-10,
                                  absorb=absorb, out_dim=16)
    L_j, R_j, r_j = jtr.svd_split(jnp.asarray(M), cutoff=1e-10,
                                  absorb=absorb, out_dim=16)
    assert int(r_t) == int(r_j) == 5
    assert L_t.shape == L_j.shape and R_t.shape == R_j.shape
    assert rel((L_t @ R_t).numpy(), M) <= 1e-5
    assert np.abs(L_t.numpy()[:, 5:]).max() == 0.0


def test_range_split_same_sketch(device_route):
    # range_split takes its sketch as an argument, so both packages get the
    # same Gaussian. On a cap-bound input (rank 32 > l = 16, the zip's use)
    # they must keep the same rank and the same subspace, and reconstruct
    # equally well.
    M = low_rank(6, 64, 64, 32, decay=0.7)
    om = np.random.default_rng(7).normal(size=(64, 16)).astype(np.complex64)
    Q_t, R_t, r_t = ttr.range_split(torch.from_numpy(M), torch.from_numpy(om))
    Q_j, R_j, r_j = jtr.range_split(jnp.asarray(M), jnp.asarray(om))
    assert int(r_t) == int(r_j) == 16
    # four sweeps at l = 16 leave each basis converged to ~1e-5
    assert np.abs(projector(Q_t, 16) - projector(Q_j, 16)).max() <= 1e-4
    err_t = rel((Q_t @ R_t).numpy(), M)
    err_j = rel(np.asarray(Q_j) @ np.asarray(R_j), M)
    assert abs(err_t - err_j) <= 1e-4


def test_sketch_matrix_is_deterministic():
    a = ttr.sketch_matrix(1234, 8, 4, torch.complex64, device="cpu")
    b = ttr.sketch_matrix(1234, 8, 4, torch.complex64, device="cpu")
    assert a.shape == (8, 4) and a.dtype == torch.complex64
    assert torch.equal(a, b)


@pytest.mark.parametrize("route", ["native", "device"])
def test_rsvd(monkeypatch, route):
    if route == "device":
        monkeypatch.setattr(jcl, "FORCE_DEVICE_PATH", True)
        monkeypatch.setattr(tcl, "FORCE_DEVICE_PATH", True)
    M = low_rank(8, 256, 64, 6, dtype=np.float32, decay=0.3)
    kw = dict(k=20, p=4, q=1, cutoff=1e-9, maxdim=16, out_dim=16)
    U_t, s_t, Vh_t, r_t = trs.rsvd(torch.from_numpy(M), 1234, **kw)
    _, s_j, _, r_j = jrs.rsvd(jnp.asarray(M), jax.random.PRNGKey(1234), **kw)
    assert int(r_t) == int(r_j) == 6
    assert rel(s_t.numpy()[:6], np.asarray(s_j)[:6]) <= 1e-5
    assert U_t.shape == (256, 16) and Vh_t.shape == (16, 64)
    rec = (U_t * s_t) @ Vh_t
    assert rel(rec.numpy(), M) <= 1e-5
    # a batch of two takes one call and agrees with the single calls
    Ms = torch.from_numpy(np.stack([M, 2 * M]))
    Ub, sb, Vhb, rb = trs.rsvd(Ms, [1234, 99], **kw)
    assert rb.tolist() == [6, 6]
    assert rel(sb[1].numpy()[:6], 2 * s_t.numpy()[:6]) <= 1e-5
    assert rel(((Ub * sb[:, None, :]) @ Vhb).numpy(), Ms.numpy()) <= 1e-5
