"""Kernel K2 on the card against its plain torch version and float64 eigh.

Needs a CUDA card (marker ``gpu``; skips here without one) and imports no
JAX, so it also runs where only the port is installed:

    python -m pytest tests/port/test_torch_k2_gpu.py -m gpu --confcutdir=tests/port

Each case checks max |lam_K2 - lam_plain| / max |lam| (the plain version
with the same sweeps, in the same dtype on the card) against
``jacobi_kernels.tolerance`` (1e-5, 5e-5 from m = 256), and
||V^H V - I||_max, ||H V - V diag(lam)||_max / ||H||_max and lam against
``torch.linalg.eigh`` in float64 against ``jacobi_kernels.rounding_bar``:
the same bar, or twice the plain version's own figure on the same input
where that is larger (its float32 rounding floor, or its unconverged
residual after few sweeps). On the cluster variant's shapes (84 < m <= 320:
the gate path's m = 160 at 4, 6 and 7 sweeps, the largest complex64 solve
below cutoff 1e-10, m = 288, and the real variant) and the group variant's
(320 < m <= 512: the route edges, the dft tutorial's m = 512 at 6 and 7
sweeps, the real variant) the eigenvalues must equal the plain version's
bit for bit: every variant sums each entry as the plain version's matrix
products do, also with more clusters or groups than the card holds at
once, launch after launch.
"""

import numpy as np
import pytest
import torch

from qilaplace_tpu_torch.ops import jacobi_kernels as jk
from qilaplace_tpu_torch.ops.jacobi import default_sweeps, fast_sweeps, jacobi_eigh


def hermitian(rng, B, m, complex_=True, spectrum=None, rank=None):
    """[B, m, m] Hermitian test matrices: Gaussian, or U diag(spectrum) U^H,
    or the Gram matrix of a rank-``rank`` block zero-padded to m."""
    cplx = lambda *s: rng.normal(size=s) + (1j * rng.normal(size=s) if complex_ else 0)  # noqa: E731
    if spectrum is not None:
        U, _ = np.linalg.qr(cplx(B, m, m))
        H = (U * np.asarray(spectrum)[None, None, :]) @ np.conj(np.swapaxes(U, -1, -2))
    elif rank is not None:
        H = np.zeros((B, m, m), dtype=complex)
        X = cplx(B, m // 2, rank)
        H[:, : m // 2, : m // 2] = X @ np.conj(np.swapaxes(X, -1, -2))
    else:
        A = cplx(B, m, m)
        H = (A + np.conj(np.swapaxes(A, -1, -2))) / 2
    return H.astype(np.complex64 if complex_ else np.float32)


def check(H_np, sweeps, device, identical=False):
    H = torch.from_numpy(H_np).to(device)
    m = H.shape[-1]
    before = jk.jacobi_eigh_k2.launches
    lam, V = jk.jacobi_eigh_k2(H, sweeps=sweeps)
    torch.cuda.synchronize()
    assert jk.jacobi_eigh_k2.launches == before + 1
    assert lam.dtype == torch.float32 and V.dtype == H.dtype
    lam_p, V_p = jk.jacobi_eigh_k2_reference(H, sweeps=sweeps)
    if identical:
        assert torch.equal(lam, lam_p)
    scale = float(lam_p.abs().max().clamp_min(1e-30))
    assert float((lam - lam_p).abs().max()) / scale <= jk.tolerance(m)
    got, plain = jk.figures(H, lam, V), jk.figures(H, lam_p, V_p)
    for k, v in got.items():
        assert v <= jk.rounding_bar(m, plain[k]), (k, v, plain[k])


@pytest.mark.gpu
@pytest.mark.parametrize("m,sweeps", [(24, 5), (40, 6), (80, 4)])
def test_k2_path_shapes_complex(cuda_device, m, sweeps):
    rng = np.random.default_rng(m)
    check(hermitian(rng, 1, m), sweeps, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 8])
def test_k2_path_shape_real(cuda_device, B):
    rng = np.random.default_rng(56 + B)
    check(hermitian(rng, B, 56, complex_=False), fast_sweeps(56), cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("m,B", [(2, 1), (4, 1), (8, 1), (16, 1), (32, 1),
                                 (56, 2), (56, 6)])
@pytest.mark.parametrize("polish", [False, True])
def test_k2_encoder_shapes(cuda_device, m, B, polish):
    # the rsvd encoder's real solves: fast sweeps, and the 4-sweep polish
    rng = np.random.default_rng(100 * m + B)
    check(hermitian(rng, B, m, complex_=False), 4 if polish else fast_sweeps(m),
          cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [2, jk.SMEM_MAX_M, jk.SMEM_MAX_M + 2, 256,
                               jk.CLUSTER_MAX_M, jk.CLUSTER_MAX_M + 2, 384,
                               448, 512])
def test_k2_route_edges(cuda_device, m):
    # above CLUSTER_MAX_M the group variant: bit-identical eigenvalues
    rng = np.random.default_rng(m)
    check(hermitian(rng, 4, m), default_sweeps(m), cuda_device,
          identical=m > jk.CLUSTER_MAX_M)


@pytest.mark.gpu
@pytest.mark.parametrize("m,B,complex_,sweeps", [
    (160, 1, True, 4), (160, 1, True, 6), (160, 1, True, 7),
    (288, 3, True, 7), (160, 1, False, 6)])
def test_k2_cluster_shapes(cuda_device, m, B, complex_, sweeps):
    # the cluster variant at the gate path's shapes, bit-identical
    # eigenvalues; one launch counted under its shape
    rng = np.random.default_rng(m + B + sweeps)
    key = (m, B, "c64" if complex_ else "f32", sweeps)
    before = jk.jacobi_eigh_k2.by_shape[key]
    check(hermitian(rng, B, m, complex_=complex_), sweeps, cuda_device,
          identical=True)
    assert jk.jacobi_eigh_k2.by_shape[key] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("m", [160, 288])
def test_k2_cluster_many_clusters_repeated(cuda_device, m):
    # more clusters than the card holds at once (132 matrices, 8 blocks
    # each), five launches: every run's eigenvalues equal the plain
    # version's bit for bit and every run's V the first's. A maker that read
    # a column across a block edge before its store landed would show as a
    # run that differs
    rng = np.random.default_rng(900 + m)
    H = torch.from_numpy(hermitian(rng, 132, m)).to(cuda_device)
    lam_p, _ = jk.jacobi_eigh_k2_reference(H, sweeps=7)
    V0 = None
    for _ in range(5):
        lam, V = jk.jacobi_eigh_k2(H, sweeps=7)
        torch.cuda.synchronize()
        assert torch.equal(lam, lam_p)
        V0 = V if V0 is None else V0
        assert torch.equal(V, V0)


@pytest.mark.gpu
@pytest.mark.parametrize("m,B,complex_,sweeps", [
    (512, 1, True, 6), (512, 1, True, 7), (384, 1, True, 11),
    (512, 1, False, 7)])
def test_k2_group_shapes(cuda_device, m, B, complex_, sweeps):
    # the group variant at the dft tutorial's shapes (its exact apply's
    # chi-512 canonicalize), m = 384 and the real variant: bit-identical
    # eigenvalues; one launch counted under its shape
    rng = np.random.default_rng(m + B + sweeps + complex_)
    key = (m, B, "c64" if complex_ else "f32", sweeps)
    before = jk.jacobi_eigh_k2.by_shape[key]
    check(hermitian(rng, B, m, complex_=complex_), sweeps, cuda_device,
          identical=True)
    assert jk.jacobi_eigh_k2.by_shape[key] == before + 1


@pytest.mark.gpu
def test_k2_group_many_groups_repeated(cuda_device):
    # more groups than the card holds at once (9 matrices of m = 512 on
    # groups of 32 blocks: 4 resident on 132 SMs, each taking its matrices
    # in turn), three launches: every run's eigenvalues equal the plain
    # version's bit for bit and every run's V the first's. A block that read
    # a column or a rotation before its writer published it would show as a
    # run that differs
    rng = np.random.default_rng(512)
    H = torch.from_numpy(hermitian(rng, 9, 512)).to(cuda_device)
    lam_p, _ = jk.jacobi_eigh_k2_reference(H, sweeps=7)
    V0 = None
    for _ in range(3):
        lam, V = jk.jacobi_eigh_k2(H, sweeps=7)
        torch.cuda.synchronize()
        assert torch.equal(lam, lam_p)
        V0 = V if V0 is None else V0
        assert torch.equal(V, V0)


@pytest.mark.gpu
@pytest.mark.parametrize("m,complex_", [(512, True), (384, False)])
def test_k2_group_slots_alone(cuda_device, m, complex_):
    # B = 4 distinct matrices: each slot equal to its matrix launched alone
    rng = np.random.default_rng(40 + m)
    H = torch.from_numpy(hermitian(rng, 4, m, complex_=complex_)).to(cuda_device)
    lam, V = jk.jacobi_eigh_k2(H, sweeps=6)
    for b in range(4):
        lam_b, V_b = jk.jacobi_eigh_k2(H[b:b + 1], sweeps=6)
        torch.cuda.synchronize()
        assert torch.equal(lam[b], lam_b[0]) and torch.equal(V[b], V_b[0])


@pytest.mark.gpu
@pytest.mark.parametrize("sweeps", [default_sweeps(24), 12])
def test_k2_degenerate_spectrum(cuda_device, sweeps):
    # clusters converge more slowly: at default sweeps (7) the plain version
    # itself leaves a residual above 1e-5, which the kernel may share; at 12
    # both are converged
    rng = np.random.default_rng(7)
    spectrum = np.repeat([-2.0, 0.5, 0.5000001, 3.0], 6)
    check(hermitian(rng, 2, 24, spectrum=spectrum), sweeps, cuda_device)


@pytest.mark.gpu
def test_k2_zero_padded(cuda_device):
    rng = np.random.default_rng(8)
    check(hermitian(rng, 2, 24, rank=3), default_sweeps(24), cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [2, 24, 56, jk.SMEM_MAX_M, jk.SMEM_MAX_M + 2, 256,
                               512])
def test_k2_real_variant(cuda_device, m):
    # float32 stays float32 through the kernel: the launch is counted as a
    # real solve, V comes back real, and it holds against the plain version
    rng = np.random.default_rng(300 + m)
    H = hermitian(rng, 2, m, complex_=False)
    sweeps = fast_sweeps(m)
    before = jk.jacobi_eigh_k2.by_shape[(m, 2, "f32", sweeps)]
    check(H, sweeps, cuda_device)
    assert jk.jacobi_eigh_k2.by_shape[(m, 2, "f32", sweeps)] == before + 1
    _, V = jk.jacobi_eigh_k2(torch.from_numpy(H).to(cuda_device), sweeps=sweeps)
    assert V.dtype == torch.float32 and not V.is_complex()


@pytest.mark.gpu
def test_k2_rejects_what_it_does_not_take(cuda_device):
    H = torch.eye(6, dtype=torch.complex64, device=cuda_device)
    with pytest.raises(ValueError):
        jk.jacobi_eigh_k2(H[:5, :5])
    with pytest.raises(TypeError):
        jk.jacobi_eigh_k2(H.to(torch.complex128))
    with pytest.raises(ValueError):
        jk.jacobi_eigh_k2(torch.eye(514, dtype=torch.complex64,
                                    device=cuda_device))


@pytest.mark.gpu
def test_device_route_takes_k2_on_the_card(cuda_device):
    from qilaplace_tpu_torch.ops.truncation import truncated_svd

    rng = np.random.default_rng(3)
    M = torch.from_numpy((rng.normal(size=(128, 8)) @ rng.normal(size=(8, 128))
                          ).astype(np.complex64)).to(cuda_device)
    before, plain = jk.jacobi_eigh_k2.launches, jacobi_eigh.cuda_calls
    U, s, Vh, rank = truncated_svd(M, cutoff=1e-12, maxdim=16)
    assert jk.jacobi_eigh_k2.launches > before
    assert jacobi_eigh.cuda_calls == plain
    assert int(rank) == 8
    rec = (U * s.to(U.dtype)) @ Vh
    assert float((rec - M).abs().max() / M.abs().max()) < 1e-4
