"""Randomized truncated SVD, the encoder's workhorse.

Counterpart of ``qilaplace_tpu/ops/rsvd.py``: one large GEMM range finder,
a padding-safe Gram orthonormalization, ``q`` power iterations and a small
dense SVD. ``rsvd`` also takes a leading batch dimension, which stands in
for the JAX encoder's ``vmap`` over sibling tree nodes: a batch of B
matrices makes each eigensolve one K2 launch with B > 1 on the card.

Randomness: the JAX package draws each sketch from a PRNG key; here from a
``torch.Generator`` seeded with an integer (one per batch element), on the
host, so the host and the card see the same sketch
(ops.truncation.sketch_matrix).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qilaplace_tpu_torch.ops.complexlinalg import (
    _native_complex_linalg,
    csvd,
    gram_orthonormalize,
    mm,
)
from qilaplace_tpu_torch.ops.jacobi import fast_sweeps
from qilaplace_tpu_torch.ops.truncation import (
    _fit,
    _gram_svd,
    _is_fast,
    _mask,
    sketch_matrix,
    truncation_rank,
)


def rsvd(M: torch.Tensor, key, *, k: int = 20, p: int = 10, q: int = 0,
         cutoff: float = 1e-15, maxdim: int | None = None, mindim: int = 1,
         out_dim: int | None = None):
    """Randomized SVD of a (possibly zero-padded) matrix ``M`` [a, b], or a
    batch [..., a, b].

    ``key`` seeds the sketch: an int (one sketch shared by every matrix of
    a batch, as a ``vmap`` with an unbatched key shares it), or a sequence
    of G ints, one sketch per entry of the axis -3 of ``M`` [..., G, a, b]
    (the encoder's sibling nodes), shared over any axes before it. Returns
    ``(U, s, Vh, rank)`` with U [..., a, out_dim], s [..., out_dim],
    Vh [..., out_dim, b] and int32 rank [...]; entries at index >= rank are
    zero. ``k``: target rank, ``p``: oversampling, ``q``:
    power iterations (maxdim defaults to k).
    """
    a, b = M.shape[-2:]
    # sketch width rounded up to a multiple of 8: the eigensolves on the
    # [l, l] Gram matrices take kernel K2 only for even l
    l = min(((k + p + 7) // 8) * 8, a, b)
    if maxdim is None:
        maxdim = k
    if out_dim is None:
        out_dim = min(maxdim, l)
    maxdim = min(maxdim, out_dim, l)
    sweeps = fast_sweeps(l) if _is_fast(cutoff) else None

    shared = isinstance(key, (int, np.integer))
    seeds = [key] if shared else list(key)
    if not shared and (M.dim() < 3 or len(seeds) != M.shape[-3]):
        raise ValueError("rsvd: need one seed per entry of axis -3")
    Om = torch.stack([sketch_matrix(s, b, l, M.dtype, device=M.device)
                      for s in seeds])
    if M.is_complex():  # (N(0,1) + i N(0,1)) / sqrt(2), as the JAX rsvd draws
        Om = Om / math.sqrt(2.0)
    if shared:
        Om = Om[0]

    Y = mm(M, Om)  # [..., a, l]: the big GEMM
    Q, _ = gram_orthonormalize(Y, sweeps=sweeps)
    for _ in range(q):
        Qz, _ = gram_orthonormalize(mm(M.mH, Q), sweeps=sweeps)
        Q, _ = gram_orthonormalize(mm(M, Qz), sweeps=sweeps)

    B = mm(Q.mH, M)  # [..., l, b]
    if _native_complex_linalg(B):
        Ub, s, Vh = csvd(B)
    else:
        Ub, s, Vh = _gram_svd(B, sweeps=sweeps)
    # rank floored at the working-precision GEMM noise of the projection
    nf = 2.0 * torch.finfo(M.real.dtype).eps * float(max(a, b)) ** 0.5
    rank = truncation_rank(s, cutoff, maxdim, mindim, noise_floor=nf)
    Ub, s, Vh = _mask(Ub, s, Vh, rank)
    U = mm(Q, Ub)
    return (_fit(U, -1, out_dim), _fit(s, -1, out_dim),
            _fit(Vh, -2, out_dim), rank)
