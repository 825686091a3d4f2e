"""Hermitian eigensolves and SVDs, routed by the tensor's device.

Counterpart of ``qilaplace_tpu/ops/complexlinalg.py`` (``ceigh``, ``csvd``,
``gram_orthonormalize`` and their routing). The JAX package sends every
factorization on its accelerator to the Jacobi eigensolver (a Pallas
kernel there); here the route is decided by where the tensor lies:

* a CPU tensor goes to ``torch.linalg`` (LAPACK), unless
  ``FORCE_DEVICE_PATH`` is set; then to the plain Jacobi solver
  (ops/jacobi.py), as the JAX package does on its CPU backend;
* a CUDA tensor always takes the device route: kernel K2
  (ops/jacobi_kernels.py) for even m <= 512 in float32/complex64, the plain
  Jacobi solver for anything else.

``csvd`` on the device route is the complete-Gram SVD of
ops/truncation.py: with U a complete orthonormal eigenbasis of the smaller
Gram matrix, U (U^H M) == M for any unitary U, so the reconstruction is
exact whatever the eigenvectors' accuracy.
"""

from __future__ import annotations

import torch

from qilaplace_tpu_torch.ops.jacobi import jacobi_eigh
from qilaplace_tpu_torch.ops.jacobi_kernels import MAX_M, jacobi_eigh_k2

# Test hook: force the device (Jacobi) route for CPU tensors too.
FORCE_DEVICE_PATH = False


def _native_complex_linalg(x: torch.Tensor) -> bool:
    """True when ``x`` takes LAPACK: a CPU tensor without the hook set."""
    return x.device.type == "cpu" and not FORCE_DEVICE_PATH


def _device_eigh(H: torch.Tensor, *, sweeps: int | None = None):
    """Jacobi eigh on the device route: K2 for a CUDA tensor of even
    m <= 512 in float32/complex64, the plain solver otherwise. ``sweeps``
    overrides the per-size default (loose-cutoff truncations ask for
    fewer). Every leading axis of ``H`` [..., m, m] rides one call, so a
    batch of matrices is one K2 launch."""
    m = H.shape[-1]
    if (H.is_cuda and m % 2 == 0 and m <= MAX_M
            and H.dtype in (torch.float32, torch.complex64)):
        lam, V = jacobi_eigh_k2(H.reshape(-1, m, m), sweeps=sweeps)
        return lam.reshape(H.shape[:-1]), V.reshape(H.shape)
    return jacobi_eigh(H, sweeps=sweeps)


def ceigh(H: torch.Tensor, *, sweeps: int | None = None):
    """Hermitian eigendecomposition, ascending eigenvalues.

    Returns ``(lam [..., n] real, V [..., n, n])`` with H V = V diag(lam).
    ``sweeps`` tunes the Jacobi solver only (ignored by LAPACK).
    """
    if _native_complex_linalg(H):
        return torch.linalg.eigh(H)
    return _device_eigh(H, sweeps=sweeps)


def csvd(M: torch.Tensor):
    """Reduced SVD ``M = U diag(s) Vh`` with descending s: LAPACK for a CPU
    tensor, the complete-Gram route (ops.truncation._gram_svd) otherwise.
    """
    if _native_complex_linalg(M):
        return torch.linalg.svd(M, full_matrices=False)
    from qilaplace_tpu_torch.ops.truncation import _gram_svd

    return _gram_svd(M)


def gram_orthonormalize(Y: torch.Tensor, *, eps: float | None = None,
                        sweeps: int | None = None, ns_steps: int = 2):
    """Orthonormal basis of range(Y) via the Gram eigendecomposition,
    padding- and rank-deficiency-safe.

    ``Y`` is [a, l] or a batch [B, a, l]. Returns ``(Q, rank)`` with Q like
    Y; columns at index >= rank are exactly zero. Null directions of the
    Gram matrix are masked outright instead of being amplified, and
    ``ns_steps`` Newton-Schulz steps Q <- Q (3I - Q^H Q) / 2 restore
    orthonormality of the whitened block to working precision (its defect
    is O(eps kappa^2) <= O(1/l) by the mask threshold, and each step
    squares it).
    """
    l = Y.shape[-1]
    if eps is None:
        eps = torch.finfo(Y.real.dtype).eps
    tol = eps * l
    G = Y.mH @ Y
    lam, V = ceigh(G, sweeps=sweeps)  # ascending
    lam = torch.clamp(lam.real.flip(-1), min=0.0)
    V = V.flip(-1)
    lam_max = torch.clamp(lam[..., :1], min=torch.finfo(lam.dtype).tiny)
    keep = lam > tol * lam_max
    rank = keep.sum(-1).to(torch.int32)
    inv_sqrt = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, lam, 1.0)),
                           torch.zeros_like(lam))
    Q = Y @ (V * inv_sqrt[..., None, :].to(V.dtype))
    mask = keep[..., None, :]
    Q = torch.where(mask, Q, torch.zeros_like(Q))
    eye = torch.eye(l, dtype=Q.dtype, device=Q.device)
    for _ in range(ns_steps):
        Q = Q @ (1.5 * eye - 0.5 * (Q.mH @ Q))
    Q = torch.where(mask, Q, torch.zeros_like(Q))
    return Q, rank
