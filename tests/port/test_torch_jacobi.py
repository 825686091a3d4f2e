"""The port's Jacobi eigensolver against the JAX package's.

Same Hermitian inputs (seeded numpy) through the port's plain
``jacobi_eigh`` (the plain version of kernel K2), JAX's ``lax.scan``
``jacobi_eigh`` and JAX's Pallas kernel ``jacobi_eigh_pallas`` in
interpret mode. The bar is ``jacobi_kernels.tolerance`` (1e-5 at these
sizes): eigenvalues relative to max |lam|, V^H V - I, and the residual
H V - V diag(lam) relative to max |H|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qilaplace_tpu.ops import jacobi as jj
from qilaplace_tpu_torch.ops import jacobi as tj
from qilaplace_tpu_torch.ops import jacobi_kernels as jk


def hermitian(seed, B, m, complex_):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, m))
    if complex_:
        A = A + 1j * rng.normal(size=(B, m, m))
    H = (A + np.conj(np.swapaxes(A, -1, -2))) / 2
    return H.astype(np.complex64 if complex_ else np.float32)


def unitarity(V):
    V = np.asarray(V, dtype=np.complex128)
    return np.abs(np.conj(np.swapaxes(V, -1, -2)) @ V - np.eye(V.shape[-1])).max()


def residual(H, lam, V):
    H = np.asarray(H, dtype=np.complex128)
    V = np.asarray(V, dtype=np.complex128)
    lam = np.asarray(lam, dtype=np.float64)
    return np.abs(H @ V - V * lam[..., None, :]).max() / np.abs(H).max()


@pytest.mark.parametrize("complex_", [True, False])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("m", [2, 8, 16, 40])
def test_jacobi_eigh_matches_jax_and_pallas(m, B, complex_):
    H = hermitian(m * 10 + B, B, m, complex_)
    tol = jk.tolerance(m)
    lam_t, V_t = tj.jacobi_eigh(torch.from_numpy(H))
    lam_t, V_t = lam_t.numpy(), V_t.numpy()
    lam_j, _ = jj.jacobi_eigh(jnp.asarray(H))
    lam_p, V_p = jj.jacobi_eigh_pallas(jnp.asarray(H), interpret=True)
    scale = np.abs(lam_t).max()
    assert np.abs(lam_t - np.asarray(lam_j)).max() / scale <= tol
    assert np.abs(lam_t - np.asarray(lam_p)).max() / scale <= tol
    assert V_t.dtype == H.dtype
    assert unitarity(V_t) <= tol and unitarity(V_p) <= tol
    assert residual(H, lam_t, V_t) <= tol


@pytest.mark.parametrize("m", [7, 15])
def test_odd_m_goes_through_the_sentinel(m):
    H = hermitian(m, 2, m, True)
    lam_t, V_t = tj.jacobi_eigh(torch.from_numpy(H))
    lam_j, _ = jj.jacobi_eigh(jnp.asarray(H))
    assert lam_t.shape == (2, m) and V_t.shape == (2, m, m)
    tol = jk.tolerance(m + 1)
    scale = float(lam_t.abs().max())
    assert np.abs(lam_t.numpy() - np.asarray(lam_j)).max() / scale <= tol
    assert residual(H, lam_t, V_t) <= tol


def test_path_sweep_counts_and_float64():
    # the path's own short sweep counts agree with JAX's at the same count;
    # float64 takes default + 7 sweeps, as in the JAX package
    H = hermitian(5, 1, 24, True)
    for sweeps in (4, 5):
        lam_t, V_t = tj.jacobi_eigh(torch.from_numpy(H), sweeps=sweeps)
        lam_j, _ = jj.jacobi_eigh(jnp.asarray(H), sweeps=sweeps)
        scale = float(lam_t.abs().max())
        assert np.abs(lam_t.numpy() - np.asarray(lam_j)).max() / scale <= 1e-5
        assert unitarity(V_t) <= 1e-5
    H64 = H.astype(np.complex128)
    lam_t, V_t = tj.jacobi_eigh(torch.from_numpy(H64))
    assert residual(H64, lam_t, V_t) <= 1e-12
    assert np.abs(lam_t.numpy() - np.linalg.eigvalsh(H64)).max() <= 1e-12


def test_onesided_polish_matches_jax():
    rng = np.random.default_rng(11)
    B = (rng.normal(size=(6, 20)) + 1j * rng.normal(size=(6, 20))).astype(
        np.complex64)
    J_t, Bo_t = tj.onesided_polish(torch.from_numpy(B), sweeps=6)
    J_j, Bo_j = jj.onesided_polish(jnp.asarray(B), sweeps=6)
    rn_t = np.sort(np.linalg.norm(Bo_t.numpy(), axis=1))
    rn_j = np.sort(np.linalg.norm(np.asarray(Bo_j), axis=1))
    assert np.abs(rn_t - rn_j).max() / rn_j.max() <= 1e-5
    assert unitarity(J_t) <= 1e-5
    G = Bo_t.numpy() @ np.conj(Bo_t.numpy().T)
    assert np.abs(G - np.diag(np.diag(G))).max() / np.abs(G).max() <= 1e-5
    assert np.abs(J_t.numpy() @ Bo_t.numpy() - B).max() <= 1e-5


def test_schedules_match_jax():
    for m in (2, 4, 10, 40, 512):
        assert tj._tournament_sigma(m) == jj._tournament_sigma(m)
        assert tj.default_sweeps(m) == jj.default_sweeps(m)
        assert tj.fast_sweeps(m) == jj.fast_sweeps(m)


def test_k2_wrapper_routes_cpu_to_plain_version():
    H = torch.from_numpy(hermitian(3, 2, 8, True))
    before = jk.jacobi_eigh_k2.launches
    lam, V = jk.jacobi_eigh_k2(H, sweeps=3)
    lam_p, V_p = tj.jacobi_eigh(H, sweeps=3)
    assert jk.jacobi_eigh_k2.launches == before  # no kernel on the CPU
    assert torch.equal(lam, lam_p) and torch.equal(V, V_p)
    lam_d, _ = jk.jacobi_eigh_k2(H)  # default sweeps
    assert torch.equal(lam_d, tj.jacobi_eigh(H)[0])
