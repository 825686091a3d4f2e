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

A batch of factorizations on the card takes each eigensolve as one K2
launch, and its plain products, sums and scans one slot at a time
(``per_slot``), so every slot computes bit for bit what its matrix alone
computes.
"""

from __future__ import annotations

import itertools

import torch

from qilaplace_tpu_torch.ops.jacobi import jacobi_eigh
from qilaplace_tpu_torch.ops.jacobi_kernels import MAX_M, jacobi_eigh_k2

# Test hook: force the device (Jacobi) route for CPU tensors too.
FORCE_DEVICE_PATH = False


def _native_complex_linalg(x: torch.Tensor) -> bool:
    """True when ``x`` takes LAPACK: a CPU tensor without the hook set."""
    return x.device.type == "cpu" and not FORCE_DEVICE_PATH


def per_slot(fn, *xs, core=2):
    """``fn(*xs)``, computed on the card one slot of the leading axes at a
    time.

    Each operand has ``core`` trailing axes (an int for all, or one per
    operand); the axes before them broadcast. On the CPU, or without
    leading axes, this is ``fn(*xs)``. On the card, cuBLAS's batched
    products (and PyTorch's batched sums and scans) add in another order
    than the same call on one matrix, and a truncation at the cutoff's
    edge turns a last-bit difference into another rank; one call a slot
    keeps each slot of a batched factorization what its matrix alone
    computes."""
    cores = (core,) * len(xs) if isinstance(core, int) else core
    leads = [x.shape[:x.dim() - c] for x, c in zip(xs, cores)]
    if not any(leads) or not any(x.is_cuda for x in xs):
        return fn(*xs)
    return _each_slot(fn, xs, leads, _broadcast(leads))


def _broadcast(leads):
    """``torch.broadcast_shapes(*leads)`` as a tuple, at a tenth of its
    host time."""
    out = [1] * max(map(len, leads))
    for ld in leads:
        for k, d in enumerate(ld, len(out) - len(ld)):
            if d != 1:
                if out[k] not in (1, d):
                    raise ValueError(f"per_slot: leading axes {leads} do "
                                     "not broadcast")
                out[k] = d
    return tuple(out)


def _each_slot(fn, xs, leads, lead):
    """``fn`` on every slot of the broadcast leading axes ``lead``, stacked;
    each operand is taken through its own leading axes ``leads``."""
    slots = list(itertools.product(*map(range, lead)))
    if not slots:
        return fn(*xs)
    cols = []
    for x, ld in zip(xs, leads):
        if not ld:
            cols.append([x] * len(slots))
        elif ld == lead and len(ld) == 1:
            cols.append(x.unbind(0))
        else:
            cols.append([x[tuple(i if d > 1 else 0 for i, d in zip(
                idx[len(idx) - len(ld):], ld))] for idx in slots])
    outs = [fn(*args) for args in zip(*cols)]
    return torch.stack(outs).reshape(*lead, *outs[0].shape)


def mm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y``, one product a slot on the card (``per_slot``)."""
    return per_slot(torch.matmul, x, y)


def slot_einsum(eq: str, *xs: torch.Tensor, core) -> torch.Tensor:
    """``torch.einsum(eq, *xs)`` (``...`` for the leading axes), one call a
    slot on the card (``per_slot``; ``core``: each operand's own axes)."""
    return per_slot(lambda *ys: torch.einsum(eq, *ys), *xs, core=core)


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
    G = mm(Y.mH, Y)
    lam, V = ceigh(G, sweeps=sweeps)  # ascending
    lam = torch.clamp(lam.real.flip(-1), min=0.0)
    V = V.flip(-1)
    lam_max = torch.clamp(lam[..., :1], min=torch.finfo(lam.dtype).tiny)
    keep = lam > tol * lam_max
    rank = keep.sum(-1).to(torch.int32)
    inv_sqrt = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, lam, 1.0)),
                           torch.zeros_like(lam))
    Q = mm(Y, V * inv_sqrt[..., None, :].to(V.dtype))
    mask = keep[..., None, :]
    Q = torch.where(mask, Q, torch.zeros_like(Q))
    eye = torch.eye(l, dtype=Q.dtype, device=Q.device)
    for _ in range(ns_steps):
        Q = mm(Q, 1.5 * eye - 0.5 * mm(Q.mH, Q))
    Q = torch.where(mask, Q, torch.zeros_like(Q))
    return Q, rank
