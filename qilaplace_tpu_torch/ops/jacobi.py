"""Batched Hermitian Jacobi eigensolver, plain torch.

Counterpart of ``qilaplace_tpu/ops/jacobi.py`` (``jacobi_eigh``,
``onesided_polish`` and the sweep schedules). A cyclic parallel-order
(Brent-Luk round-robin) two-sided Jacobi solver: each round applies m/2
independent 2x2 rotations on the position pairs (2i, 2i+1) as one
block-diagonal unitary Q, then permutes positions with the static
tournament rotation; m-1 rounds visit every index pair once (one sweep).
V is a product of elementary unitary rotations, so it is unitary to
working precision at any sweep count.

This is the plain version of kernel K2 (ops/jacobi_kernels.py,
csrc/jacobi_eigh.cu): what the kernel is checked against on the card, and
the solver of the device route for a CPU tensor (``FORCE_DEVICE_PATH``)
and for shapes the kernel does not take. Calls on a CUDA tensor are
counted in ``jacobi_eigh.cuda_calls``, so a run can show that its path
went through the kernel instead.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _tournament_sigma(m: int) -> tuple:
    """Static position permutation for the Brent-Luk tournament.

    Positions pair as (2i, 2i+1). Returns sigma with
    ``arrangement_next[p] = arrangement[sigma[p]]``; applying it m-1 times
    cycles every pair through some position pair exactly once and returns
    to the identity arrangement.
    """
    if m % 2:
        raise ValueError("tournament needs even m")
    c = m // 2
    # pos -> round-robin list index: pair i = (L[i], L[m-1-i])
    pi = np.empty(m, dtype=np.int64)
    for i in range(c):
        pi[2 * i] = i
        pi[2 * i + 1] = m - 1 - i
    pi_inv = np.argsort(pi)
    # list rotation: L'[0] = L[0], L'[1] = L[m-1], L'[j] = L[j-1]
    rho = np.empty(m, dtype=np.int64)
    rho[0] = 0
    rho[1] = m - 1
    rho[2:] = np.arange(1, m - 1)
    sigma = pi_inv[rho[pi]]
    # verify: m-1 rounds cover all pairs and return to start
    arr = np.arange(m)
    seen = set()
    for _ in range(m - 1):
        for i in range(c):
            a, b = int(arr[2 * i]), int(arr[2 * i + 1])
            seen.add((min(a, b), max(a, b)))
        arr = arr[sigma]
    assert len(seen) == m * (m - 1) // 2, "tournament schedule incomplete"
    assert np.array_equal(arr, np.arange(m)), "tournament not cyclic"
    return tuple(int(s) for s in sigma)


def default_sweeps(m: int) -> int:
    """Sweep count giving about working-precision convergence for the
    bucket sizes used here (m <= 512)."""
    if m <= 8:
        return 5
    if m <= 32:
        return 7
    if m <= 128:
        return 9
    return 11


def fast_sweeps(m: int) -> int:
    """Reduced sweep count for loose-cutoff truncations (>= ~1e-10
    relative squared): Jacobi converges quadratically, so 4-7 sweeps put
    the off-diagonal residual far below that budget. V stays unitary at
    any sweep count, so the complete-Gram SVD route stays exact."""
    if m <= 8:
        return 4
    if m <= 32:
        return 5
    if m <= 128:
        return 6
    return 7


def _pair_rotations(a, b, wr, wi):
    """Per pair: the rotation J = [[c0, -z], [conj(z), c0]], z = s0 u,
    u = w / |w|, that diagonalizes [[a, w], [conj(w), b]]; returns the real
    tensors (c0, Re z, Im z). Pairs with w == 0 get the identity. The tau
    == 0 tie takes t = +1."""
    absw = torch.hypot(wr, wi)
    rotate = absw > 0
    safe = torch.where(rotate, absw, 1.0)
    tau = (a - b) / (2.0 * safe)
    sgn = torch.where(tau >= 0, 1.0, -1.0)
    t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(rotate, t, 0.0)
    c0 = 1.0 / torch.sqrt(1.0 + t * t)
    f = t * c0 / safe  # s0 / |w|
    return c0, wr * f, wi * f


@lru_cache(maxsize=None)
def _rotation_slots_host(m: int, cplx: bool) -> tuple:
    """Flat indices into Qp = Q P (for complex Qp: into its real view,
    [m, m, 2] floats) of every pair's 2x2 block entries, in the order
    re (p,p), re (p,q), re (q,p), re (q,q) [, im (p,q), im (q,p)], each
    over the pairs i (p = 2i, q = 2i + 1)."""
    sigma = np.asarray(_tournament_sigma(m))
    col = np.argsort(sigma)  # Q's column j lands at Qp column col[j]
    p = np.arange(0, m, 2)
    q = p + 1
    k = 2 if cplx else 1
    re = [(r * m + col[j]) * k for r, j in ((p, p), (p, q), (q, p), (q, q))]
    if cplx:
        re += [re[1] + 1, re[2] + 1]
    return tuple(np.concatenate(re).tolist())


def _rotation_slots(m: int, cplx: bool, device) -> torch.Tensor:
    return torch.tensor(_rotation_slots_host(m, cplx), device=device)


def _block_diag(c0, zr, zi, dtype) -> torch.Tensor:
    """Pair rotations (c0, z) [..., c] -> block-diagonal [..., 2c, 2c] of
    J_i = [[c0, -z], [conj(z), c0]]."""
    c = c0.shape[-1]
    z = torch.complex(zr, zi) if dtype.is_complex else zr
    zc = z.conj() if dtype.is_complex else z
    c0 = c0.to(dtype)
    J = torch.stack([torch.stack([c0, -z], -1), torch.stack([zc, c0], -1)],
                    -2)  # [..., c, 2, 2]
    eye_c = torch.eye(c, dtype=dtype, device=c0.device)
    Q = eye_c[:, None, :, None] * J[..., :, :, None, :]
    return Q.reshape(*J.shape[:-3], 2 * c, 2 * c)


def jacobi_eigh(H: torch.Tensor, *, sweeps: int | None = None):
    """Hermitian eigendecomposition via parallel-order cyclic Jacobi.

    H: [..., m, m] Hermitian (complex or real symmetric). Returns
    ``(lam [..., m] real ascending, V [..., m, m])`` with ``H V = V
    diag(lam)`` and V unitary to working precision whatever ``sweeps``.
    Odd m is padded with a sentinel row and column: its couplings are zero,
    so every rotation touching it is the identity, and its huge negative
    diagonal sorts it first, where it is sliced away.
    """
    if H.is_cuda:
        jacobi_eigh.cuda_calls += 1
    m0 = H.shape[-1]
    if H.shape[-2] != m0:
        raise ValueError("jacobi_eigh: matrix must be square")
    if m0 == 1:
        return H[..., 0, 0].real[..., None], torch.ones_like(H)
    rdtype = H.real.dtype
    odd = m0 % 2
    if odd:
        m = m0 + 1
        Hp = H.new_zeros(*H.shape[:-2], m, m)
        Hp[..., :m0, :m0] = H
        Hp[..., m0, m0] = -torch.finfo(rdtype).max / 8
        H = Hp
    else:
        m = m0
    if sweeps is None:
        sweeps = default_sweeps(m)
        if torch.finfo(rdtype).bits >= 64:
            sweeps += 7  # f64 floors lower; the quadratic tail needs more

    dtype = H.dtype
    c = m // 2
    idx = _rotation_slots(m, H.is_complex(), H.device)
    V = torch.eye(m, dtype=dtype, device=H.device).expand(H.shape).clone()
    # Qp = Q P, the round's block-diagonal rotation with the tournament
    # permutation folded in; its nonzero slots are the same every round
    Qp = torch.zeros(H.shape, dtype=dtype, device=H.device)
    Qflat = (torch.view_as_real(Qp) if H.is_complex() else Qp[..., None])
    Qflat = Qflat.reshape(*H.shape[:-2], -1)
    for _ in range(sweeps * (m - 1)):
        D = H.reshape(*H.shape[:-2], c, 2, c, 2).diagonal(dim1=-4, dim2=-2)
        w = D[..., 0, 1, :]
        wr, wi = ((w.real, w.imag) if H.is_complex()
                  else (w, torch.zeros_like(w)))
        c0, zr, zi = _pair_rotations(D[..., 0, 0, :].real,
                                     D[..., 1, 1, :].real, wr, wi)
        if H.is_complex():
            vals = torch.cat([c0, -zr, zr, c0, -zi, -zi], dim=-1)
        else:
            vals = torch.cat([c0, -zr, zr, c0], dim=-1)
        Qflat[..., idx] = vals
        H = Qp.mH @ H @ Qp
        V = V @ Qp
    lam = H.diagonal(dim1=-2, dim2=-1).real
    lam, order = torch.sort(lam, dim=-1)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    if odd:
        lam = lam[..., 1:]
        V = V[..., :m0, 1:]
    return lam, V


jacobi_eigh.cuda_calls = 0


def onesided_polish(B: torch.Tensor, *, sweeps: int = 2):
    """One-sided Jacobi polish: orthogonalize the ROWS of ``B`` [..., m, b].

    Returns ``(J [..., m, m] unitary, B_out = J^H B)`` with the rows of
    ``B_out`` mutually orthogonal to working precision. Rotation angles
    come from fresh row inner products of the current B each round
    (linear, not squared, conditioning).
    """
    m0 = B.shape[-2]
    if m0 == 1:
        return torch.ones(*B.shape[:-2], 1, 1, dtype=B.dtype,
                          device=B.device), B
    odd = m0 % 2
    if odd:  # a zero row: every rotation touching it is the identity
        B = torch.cat([B, B.new_zeros(*B.shape[:-2], 1, B.shape[-1])],
                      dim=-2)
    m = m0 + odd
    dtype = B.dtype
    tiny = torch.finfo(B.real.dtype).tiny
    sigma = torch.tensor(_tournament_sigma(m), device=B.device)
    Jacc = torch.eye(m, dtype=dtype, device=B.device).expand(
        *B.shape[:-2], m, m).clone()
    for _ in range(sweeps * (m - 1)):
        rn = (B.abs() ** 2).sum(dim=-1)  # row squared norms
        w = (B[..., 0::2, :] * B[..., 1::2, :].conj()).sum(dim=-1)
        # skip pairs already orthogonal relative to their norms: a rotation
        # from pure roundoff would mix converged rows for no benefit
        w = torch.where(w.abs() > tiny, w, torch.zeros_like(w))
        wr, wi = (w.real, w.imag) if w.is_complex() else (w, w * 0)
        Q = _block_diag(*_pair_rotations(rn[..., 0::2], rn[..., 1::2], wr, wi),
                        dtype)
        B = (Q.mH @ B)[..., sigma, :]
        Jacc = (Jacc @ Q)[..., sigma]
    if odd:
        B = B[..., :m0, :]
        Jacc = Jacc[..., :m0, :m0]
    return Jacc, B
