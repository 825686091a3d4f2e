"""Masked truncated SVD, the static-shape stand-in for dynamic bond
truncation.

Counterpart of ``qilaplace_tpu/ops/truncation.py``. Every matrix carries a
zero-padding invariant: entries outside the valid leading block are exactly
zero, so a truncation is a mask update (discarded singular triplets are
zeroed and the new rank is kept as an int32 tensor) and no shape changes.
Ranks stay on the device, so a sweep never waits for the host.

Cutoff semantics are ITensors' relative squared rule: discard the smallest
singular values whose total squared weight does not exceed ``cutoff``
times the total squared weight.

Routing (``truncated_svd``): LAPACK for a CPU tensor; on the device route,
the complete-Gram factorization through the Jacobi eigensolver (kernel K2
on the card) when the small side is small, else a randomized range-finder
sketch (GEMM, Gram orthonormalization, the complete-Gram step on the
[l, b] projection). Under sketching the cutoff rule still counts the mass
outside the captured subspace: the total squared weight is ||M||_F^2.

Sketches are Gaussian matrices drawn from a ``torch.Generator`` seeded with
the integer the JAX package gives its PRNG key (1234); the numbers differ
from JAX's, so tests compare only what the sketch does not decide.
"""

from __future__ import annotations

import torch

from qilaplace_tpu_torch.ops.complexlinalg import (
    _device_eigh,
    _native_complex_linalg,
    csvd,
    gram_orthonormalize,
    mm,
    per_slot,
)
from qilaplace_tpu_torch.ops.jacobi import fast_sweeps, onesided_polish
from qilaplace_tpu_torch.utils.config import real_dtype, resolve_device

# At relative squared cutoffs >= this, the device route runs fewer Jacobi
# sweeps and no power iteration (factorization residuals land far below
# the truncation scale sqrt(cutoff) ~ 3e-5).
FAST_CUTOFF = 1e-10

# Second-pass (graded-Gram refinement) sweep count; see _gram_svd.
POLISH_SWEEPS = 4


def _is_fast(cutoff) -> bool:
    """A loose cutoff (>= FAST_CUTOFF): the fast factorization profile."""
    return isinstance(cutoff, (int, float)) and cutoff >= FAST_CUTOFF


def truncation_rank(s: torch.Tensor, cutoff, maxdim, mindim=1, *,
                    total=None, noise_floor=None) -> torch.Tensor:
    """Number of singular values kept under the relative-squared-cutoff
    rule, as an int32 tensor in [mindim, min(maxdim, k)].

    ``s`` [..., k] must be non-negative and sorted descending. ``total``
    overrides the total squared weight (pass ||M||_F^2 when ``s`` spans
    only a captured subspace). ``noise_floor`` (relative to s_max) also
    discards singular values indistinguishable from the working
    precision's GEMM roundoff.
    """
    p = s * s
    k = s.shape[-1]
    # exact suffix sums: tail[i] = sum_{j > i} p_j
    suffix = per_slot(lambda q: q.flip(-1).cumsum(-1).flip(-1), p, core=1)
    captured = suffix[..., 0]
    total = captured if total is None else torch.maximum(total, captured)
    missing = total - captured
    tail = torch.cat([suffix[..., 1:], torch.zeros_like(suffix[..., :1])],
                     dim=-1)
    ok = (tail + missing[..., None]) <= cutoff * total[..., None]
    first = torch.argmax(ok.to(torch.int32), dim=-1) + 1
    rank = torch.where(ok.any(-1), first, torch.full_like(first, k))
    if noise_floor is not None:
        smax = torch.clamp(s[..., 0], min=torch.finfo(s.dtype).tiny)
        above = (s > noise_floor * smax[..., None]).sum(-1)
        rank = torch.minimum(rank, torch.clamp(above, min=1))
    rank = torch.clamp(rank, min=mindim, max=min(maxdim, k))
    return rank.to(torch.int32)


def _round8(x: int) -> int:
    return ((x + 7) // 8) * 8


def _sort_desc(s, X, Y, y_rows: bool):
    """Order the triplets by descending s (stable, as argsort(-s)): the
    columns of ``X`` and the rows (``y_rows``) or columns of ``Y``."""
    s, order = torch.sort(s, dim=-1, descending=True, stable=True)
    cols = order.unsqueeze(-2)
    X = torch.gather(X, -1, cols.expand(X.shape))
    if y_rows:
        Y = torch.gather(Y, -2, order.unsqueeze(-1).expand(Y.shape))
    else:
        Y = torch.gather(Y, -1, cols.expand(Y.shape))
    return s, X, Y


def _gram_svd(M: torch.Tensor, sweeps: int | None = None,
              polish: int = POLISH_SWEEPS, os_sweeps: int = 0):
    """Complete-Gram SVD on the device route, with refinement passes for
    linear (not squared) truncation accuracy. ``M`` is [a, b] or batched
    [..., a, b]; returns ``(U, s, Vh)`` with s descending.

    Pass 1: U = complete eigenbasis of the small-side Gram; M = U (U^H M)
    is exact for any unitary U, but columns below sqrt(eps) s_max are
    noise. Pass 2 (``polish``): the rows of B = U^H M are near the singular
    directions, so their fresh Gram is graded and one more eigensolve drops
    the noise floor toward eps s_max. Pass 3 (``os_sweeps``): one-sided
    Jacobi on the rows of B.
    """
    a, b = M.shape[-2:]
    eps = torch.finfo(M.real.dtype).eps
    tiny = torch.finfo(M.real.dtype).tiny
    if a <= b:
        _, U = _device_eigh(mm(M, M.mH), sweeps=sweeps)
        B = mm(U.mH, M)
        if polish:
            _, V2 = _device_eigh(mm(B, B.mH), sweeps=polish)
            U = mm(U, V2)
            B = mm(V2.mH, B)
        if os_sweeps:
            J, B = onesided_polish(B, sweeps=os_sweeps)
            U = mm(U, J)
        s = per_slot(lambda b: torch.linalg.vector_norm(b, dim=-1), B)
        s, U, B = _sort_desc(s, U, B, y_rows=True)
        smax = torch.clamp(s[..., :1], min=tiny)
        keep = s > 4.0 * eps * smax
        inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0),
                          torch.zeros_like(s))
        return U, s, B * inv[..., :, None].to(M.dtype)
    _, V = _device_eigh(mm(M.mH, M), sweeps=sweeps)
    B = mm(M, V)
    if polish:
        _, W2 = _device_eigh(mm(B.mH, B), sweeps=polish)
        V = mm(V, W2)
        B = mm(B, W2)
    if os_sweeps:
        J, Bt = onesided_polish(B.mH, sweeps=os_sweeps)
        V = mm(V, J)
        B = Bt.mH
    s = per_slot(lambda b: torch.linalg.vector_norm(b, dim=-2), B)
    s, V, B = _sort_desc(s, V, B, y_rows=False)
    smax = torch.clamp(s[..., :1], min=tiny)
    keep = s > 4.0 * eps * smax
    inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0),
                      torch.zeros_like(s))
    return B * inv[..., None, :].to(M.dtype), s, V.mH


def _gaussian(b: int, l: int, dtype: torch.dtype, device: torch.device,
              seed: int) -> torch.Tensor:
    """Deterministic Gaussian [b, l] (complex: independent real and
    imaginary parts, each N(0, 1)), drawn on the host from
    a generator seeded with ``seed`` so the host and the card see the same
    numbers; the same seed gives the same matrix on every call."""
    gen = torch.Generator().manual_seed(seed)
    rdt = real_dtype(dtype)
    out = torch.randn(b, l, generator=gen, dtype=rdt)
    if dtype.is_complex:
        out = torch.complex(out, torch.randn(b, l, generator=gen, dtype=rdt))
    return out.to(device=device, dtype=dtype)


def _sketched_svd(M: torch.Tensor, l: int, power_iters: int,
                  sweeps: int | None = None, polish: int = POLISH_SWEEPS):
    """Randomized top-l factorization: returns (U [..., a, l], s [..., l],
    Vh [..., l, b]) of ``M`` [..., a, b].

    Range finder, Gram orthonormalization and power iteration, then the
    complete-Gram step on the small projection. The orthonormalization
    masks null directions exactly: the zip-up matrices this sees are
    rank-deficient. A batch shares one Gaussian, as the JAX package's
    ``vmap`` shares its unbatched key."""
    a, b = M.shape[-2:]
    transpose = a > b
    if transpose:
        M = M.mH
        a, b = b, a
    Om = _gaussian(b, l, M.dtype, M.device, 1234)
    # 8 eps relative-lambda mask floor (see range_split); three
    # Newton-Schulz passes absorb the larger whitening defect
    eps8 = 8.0 * torch.finfo(M.real.dtype).eps / l
    Q, _ = gram_orthonormalize(mm(M, Om), eps=eps8, sweeps=sweeps,
                               ns_steps=3)
    for _ in range(power_iters):
        Q, _ = gram_orthonormalize(mm(M.mH, Q), eps=eps8, sweeps=sweeps,
                                   ns_steps=3)
        Q, _ = gram_orthonormalize(mm(M, Q), eps=eps8, sweeps=sweeps,
                                   ns_steps=3)
    B = mm(Q.mH, M)  # [l, b]
    Ub, s, Vh = _gram_svd(B, sweeps=sweeps, polish=polish)
    U = mm(Q, Ub)
    if transpose:
        return Vh.mH, s, U.mH
    return U, s, Vh


def _mask(U, s, Vh, rank):
    """Zero the triplets at index >= rank."""
    keep = torch.arange(s.shape[-1], device=s.device) < rank[..., None]
    s = torch.where(keep, s, torch.zeros_like(s))
    U = torch.where(keep[..., None, :], U, torch.zeros_like(U))
    Vh = torch.where(keep[..., :, None], Vh, torch.zeros_like(Vh))
    return U, s, Vh


def truncated_svd(M: torch.Tensor, *, cutoff=0.0, maxdim=None, mindim=1,
                  power_iters: int = 1, fast: bool | None = None):
    """SVD with mask-based truncation.

    Returns ``(U, s, Vh, rank)`` with U [a, k], s [k], Vh [k, b] for some
    k <= min(a, b) (k < min(a, b) on the sketched route); columns and rows
    at index >= rank are zero. ``M`` may carry leading batch axes
    [..., a, b]: every output then carries them too, and each matrix gets
    its own rank.

    Factorization profiles on the device route: fast (loose cutoffs, or
    ``fast=True``): fast pass-1 sweeps, a 4-sweep graded polish, no power
    iteration; tight float32: fast pass-1 sweeps and a 6-sweep polish;
    tight float64: default sweeps and power iteration, always on the
    complete-Gram route.
    """
    a, b = M.shape[-2:]
    k = min(a, b)
    if maxdim is None:
        maxdim = k
    maxdim = min(maxdim, k)
    if fast is None:
        fast = _is_fast(cutoff)
    f32 = M.real.dtype == torch.float32
    sweeps = None
    if fast:
        power_iters = 0
        polish = POLISH_SWEEPS
    elif f32:
        power_iters = 0
        polish = 6
    else:
        polish = POLISH_SWEEPS

    # working-precision noise floor for the rank decision
    nf = 2.0 * torch.finfo(M.real.dtype).eps * float(max(a, b)) ** 0.5

    if _native_complex_linalg(M):
        U, s, Vh = csvd(M)
        rank = truncation_rank(s, cutoff, maxdim, mindim, noise_floor=nf)
    else:
        l = min(k, _round8(maxdim + min(32, max(8, maxdim // 4))))
        # the sketch's capture floors at ~sqrt(8 eps) s_max: fine for the
        # fast and f32 profiles; the tight-f64 route always takes the
        # complete-Gram step
        if k <= max(64, (5 * l) // 4) or not (fast or f32):
            U, s, Vh = _gram_svd(
                M, sweeps=fast_sweeps(k) if (fast or f32) else None,
                polish=polish,
            )
            rank = truncation_rank(s, cutoff, maxdim, mindim, noise_floor=nf)
        else:
            if fast or f32:
                sweeps = fast_sweeps(l)
            U, s, Vh = _sketched_svd(M, l, power_iters, sweeps=sweeps,
                                     polish=polish)
            # ||M||_F^2 of each matrix of a batch, never of the batch
            total = per_slot(lambda m: (m.abs() ** 2).sum(dim=(-2, -1)),
                             M).to(s.dtype)
            rank = truncation_rank(s, cutoff, maxdim, mindim, total=total,
                                   noise_floor=nf)
    U, s, Vh = _mask(U, s, Vh, rank)
    return U, s, Vh, rank


def _fit(X: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """Slice or zero-pad ``X`` along ``dim`` to ``size``."""
    have = X.shape[dim]
    if have >= size:
        return X.narrow(dim, 0, size)
    shape = list(X.shape)
    shape[dim] = size - have
    return torch.cat([X, X.new_zeros(shape)], dim=dim)


def svd_split(M: torch.Tensor, *, cutoff=0.0, maxdim=None, mindim=1,
              absorb: str = "right", out_dim: int | None = None,
              fast: bool | None = None):
    """Split ``M`` into ``L @ R`` through a truncated SVD.

    ``absorb`` places the singular values on 'left' (L = U s, R = Vh),
    'right' (L = U, R = s Vh) or 'both' (sqrt split). The bond axis is
    padded or sliced to ``out_dim`` (default min(a, b)); exact because
    masked entries are zero and rank <= maxdim <= out_dim.

    Returns ``(L, R, rank)``; leading batch axes of ``M`` carry through.
    """
    a, b = M.shape[-2:]
    if out_dim is None:
        out_dim = min(a, b)
    if maxdim is None:
        maxdim = out_dim
    maxdim = min(maxdim, out_dim)
    U, s, Vh, rank = truncated_svd(M, cutoff=cutoff, maxdim=maxdim,
                                   mindim=mindim, fast=fast)
    sc = s.to(M.dtype)
    if absorb == "left":
        L, R = U * sc[..., None, :], Vh
    elif absorb == "right":
        L, R = U, sc[..., :, None] * Vh
    elif absorb == "both":
        sq = torch.sqrt(s).to(M.dtype)
        L, R = U * sq[..., None, :], sq[..., :, None] * Vh
    else:
        raise ValueError("absorb must be 'left', 'right' or 'both'")
    return _fit(L, -1, out_dim), _fit(R, -2, out_dim), rank


def range_split(M: torch.Tensor, om: torch.Tensor, *,
                sweeps: int | None = None):
    """Cap-only randomized split ``M ~= Q @ R`` with ``R = Q^H M`` and Q an
    orthonormal basis of the sketched range ``M @ om`` (om: [b, l]
    Gaussian): one eigensolve and the Newton-Schulz passes, for zip stages
    whose bond rides its cap (cutoff 0).

    Returns ``(Q [a, l], R [l, b], rank)``; columns/rows past ``rank`` are
    exact zeros.
    """
    l = om.shape[1]
    if sweeps is None:
        sweeps = max(3, fast_sweeps(l) - 1)
    Y = mm(M, om.to(M.dtype))
    # mask floor at 8 eps in relative lambda (not eps l): the zip must keep
    # directions down to the truncation amplitude ~sqrt(cutoff)
    eps8 = 8.0 * torch.finfo(M.real.dtype).eps / l
    Q, rank = gram_orthonormalize(Y, eps=eps8, sweeps=sweeps, ns_steps=3)
    return Q, mm(Q.mH, M), rank


def sketch_matrix(seed: int, b: int, l: int, dtype, *, device=None):
    """Gaussian sketch [b, l] for :func:`range_split` (complex when dtype
    is), from a generator seeded with ``seed``, on ``device`` (the card
    unless told otherwise)."""
    return _gaussian(b, l, dtype, resolve_device(device), int(seed))


def orthogonal_split(M: torch.Tensor, *, side: str = "left",
                     out_dim: int | None = None):
    """Gauge-fixing split with no truncation beyond exact zeros.

    side='left':  M = Q @ C with Q having orthonormal valid columns.
    side='right': M = C @ Q with Q having orthonormal valid rows.
    Returns ``(Q, C, rank)`` shaped like svd_split.
    """
    if side == "left":
        return svd_split(M, cutoff=0.0, absorb="right", out_dim=out_dim)
    if side == "right":
        L, Q, rank = svd_split(M, cutoff=0.0, absorb="left", out_dim=out_dim)
        return Q, L, rank
    raise ValueError("side must be 'left' or 'right'")
