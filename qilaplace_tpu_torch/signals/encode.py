"""Signal -> MPS encoders (quantics tensor-train decomposition).

Counterpart of ``qilaplace_tpu/signals/encode.py``:

* big-endian quantics binding: site 1 = MSB of the sample index, so the
  row-major ``x.reshape((2,)*n)`` is the tensor;
* ``method='svd'``: sequential truncated-SVD sweep;
* ``method='rsvd'``: divide-and-conquer randomized SVD; each split is one
  large GEMM range finder (ops/rsvd.py), and the tree is processed level by
  level with same-shape sibling nodes batched into one ``rsvd`` call (the
  JAX package's ``vmap``), so each eigensolve of a level is one K2 launch;
* ``method='cross'``: the host-f64 cross encoder (signals/cross_encode.py);
* ``signal_ztmps``: per-site fan-out |s> -> |s_main>|s_copy> and an SVD
  split, the n sites' splits as one batched call.

Encoders keep the input's dtype: real signals encode in float32/float64
and the complex transform operators upcast on contact. The signal is moved
to ``device`` (the card unless told otherwise) before anything is computed.

The 'svd' and 'rsvd' sweeps also take a batch of signals [B, N]: every
tensor then carries B first and each factorization of the batch is one
call (one K2 launch on the card), as under the JAX package's ``vmap``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from qilaplace_tpu_torch.core.mps import MPS, ZTMPS
from qilaplace_tpu_torch.ops.complexlinalg import per_slot
from qilaplace_tpu_torch.ops.rsvd import rsvd
from qilaplace_tpu_torch.ops.truncation import svd_split
from qilaplace_tpu_torch.utils.config import bucket_for, resolve_device


def _pad_to_stack(core_list, chi: int) -> torch.Tensor:
    """Zero-pad per-site cores [..., l, 2, r] into one [..., n, chi, 2, chi]
    stack."""
    c0 = core_list[0]
    out = c0.new_zeros(*c0.shape[:-3], len(core_list), chi, 2, chi)
    for i, c in enumerate(core_list):
        out[..., i, : c.shape[-3], :, : c.shape[-1]] = c
    return out


def _prepare(x, device):
    """The signal [..., N] on ``device``, zero-filled to a power of 2 and
    normalized; returns ``(x, amplitude [...], n)``."""
    if isinstance(x, torch.Tensor):
        x = x.to(device)
    else:
        x = torch.from_numpy(np.asarray(x)).to(device)
    N = x.shape[-1]
    n = max(1, (N - 1).bit_length())
    if N < 2**n:
        warnings.warn(
            f"signal_mps: input length {N} is not a power of 2; zero-filling "
            f"to {2**n}. Power-of-2 lengths are recommended."
        )
        x = torch.cat([x, x.new_zeros(*x.shape[:-1], 2**n - N)], dim=-1)
    amplitude = per_slot(lambda v: torch.linalg.vector_norm(v, dim=-1), x,
                         core=1)
    safe = torch.where(amplitude == 0, torch.ones_like(amplitude), amplitude)
    return x / safe[..., None], amplitude, n


def _rank1(x) -> torch.Tensor:
    """Boundary rank 1 for each signal of ``x`` [..., N]."""
    return torch.ones(x.shape[:-1], dtype=torch.int32, device=x.device)


def _tt_svd(x, n: int, *, cutoff: float, maxdim: int):
    """Sequential left-to-right truncated-SVD sweep over ``x`` [..., 2^n].
    Returns (cores, ranks)."""
    lead = x.shape[:-1]
    cores = []
    ranks = [_rank1(x)]
    cur = x
    r_static = 1
    for i in range(n - 1):
        rest = 2 ** (n - i - 1)
        M = cur.reshape(*lead, r_static * 2, rest)
        out_dim = min(maxdim, r_static * 2, rest)
        L, R, rank = svd_split(M, cutoff=cutoff, maxdim=out_dim,
                               absorb="right", out_dim=out_dim)
        cores.append(L.reshape(*lead, r_static, 2, out_dim))
        ranks.append(rank)
        cur = R
        r_static = out_dim
    cores.append(cur.reshape(*lead, r_static, 2, 1))
    ranks.append(_rank1(x))
    return cores, ranks


def _tt_rsvd(x, n: int, seed: int, *, cutoff: float, maxdim: int, k: int,
             p: int, q: int):
    """Divide-and-conquer randomized TT decomposition, level-batched.

    Splits at the middle bond with one rsvd call and recurses on both
    halves. Each tree level groups its same-shape nodes into one batched
    rsvd call: the 2^d independent splits at depth d cost one eigensolve
    latency instead of 2^d. Node ``first``'s sketch is seeded with
    ``seed * 65536 + first`` (the JAX package folds ``first`` into its
    key); a batch of signals ``x`` [..., 2^n] shares each node's sketch.
    """
    lead = x.shape[:-1]
    g = len(lead)  # the group axis of a level's stacked nodes
    cores: list = [None] * n
    ranks: list = [None] * (n + 1)
    ranks[0] = _rank1(x)
    ranks[n] = _rank1(x)
    kp_cap = k + p

    nodes = [(x.reshape(*lead, 1, 2**n, 1), 0, n - 1)]
    while nodes:
        next_nodes: list = []
        groups: dict = {}
        for node in nodes:
            T, first, last = node
            if first == last:
                cores[first] = T  # [..., bl, 2, br]
                continue
            groups.setdefault(tuple(T.shape[-3:]), []).append(node)
        for shape, grp in groups.items():
            bl, _, br = shape
            span = grp[0][2] - grp[0][1] + 1
            nl = span // 2
            nr = span - nl
            bd = min(maxdim, kp_cap, bl * 2**nl, 2**nr * br)
            seeds = [seed * 65536 + first for _, first, _ in grp]
            kw = dict(k=k, p=p, q=q, cutoff=cutoff, maxdim=bd, out_dim=bd)
            rows, cols = bl * 2**nl, 2**nr * br
            if len(grp) == 1:
                T0 = grp[0][0].reshape(*lead, rows, cols)
                U, s, Vh, rank = rsvd(T0, seeds[0], **kw)
                U, s, Vh = U.unsqueeze(g), s.unsqueeze(g), Vh.unsqueeze(g)
                rank = rank.unsqueeze(g)
            else:
                Ms = torch.stack([T.reshape(*lead, rows, cols)
                                  for T, _, _ in grp], dim=g)
                U, s, Vh, rank = rsvd(Ms, seeds, **kw)
            for i, (_, first, last) in enumerate(grp):
                mid = first + nl - 1
                ranks[mid + 1] = rank.select(g, i)
                next_nodes.append((U.select(g, i).reshape(*lead, bl, 2**nl,
                                                          bd), first, mid))
                R = s.select(g, i)[..., :, None].to(Vh.dtype) * Vh.select(g, i)
                next_nodes.append((R.reshape(*lead, bd, 2**nr, br), mid + 1,
                                   last))
        nodes = next_nodes
    return cores, ranks


def signal_mps(x, *, method: str = "svd", cutoff: float = 1e-15,
               maxdim: int = 2**62, k: int = 20, p: int = 10, q: int = 0,
               seed: int = 1234, chi: int | None = None,
               device=None) -> MPS:
    """Encode a dense signal vector into a SignalMPS on ``device`` (the
    card unless told otherwise).

    The original Euclidean norm is stored in ``.amplitude``; the tensor
    data is unit-norm. ``method``: 'svd' (TT-SVD sweep), 'rsvd' (D&C
    randomized) or 'cross' (host-f64 cross interpolation; k/p/q are
    ignored and the cross rank is capped at min(maxdim, 256)). With 'svd'
    or 'rsvd' ``x`` may be a batch [..., N] of signals; the state then
    carries the batch axes first in every field."""
    device = resolve_device(device)
    if method == "cross":
        from qilaplace_tpu_torch.signals.cross_encode import signal_mps_cross

        return signal_mps_cross(x, cutoff=cutoff, maxdim=int(min(maxdim, 256)),
                                chi=chi, seed=seed, device=device)
    x, amplitude, n = _prepare(x, device)
    if n == 0:
        raise ValueError("signal_mps: need at least 2 samples")
    # cap ranks by the padding bucket too: a user chi with the default
    # (unbounded) maxdim must truncate at chi
    maxdim_eff = min(maxdim, 2 ** (n // 2 + 1))
    if chi is not None:
        maxdim_eff = min(maxdim_eff, chi)
    if method == "svd":
        cores, ranks = _tt_svd(x, n, cutoff=cutoff, maxdim=maxdim_eff)
    elif method == "rsvd":
        cores, ranks = _tt_rsvd(x, n, seed, cutoff=cutoff,
                                maxdim=maxdim_eff, k=k, p=p, q=q)
    else:
        raise ValueError(
            f"signal_mps: unknown method {method}; use 'svd', 'rsvd' or "
            "'cross'"
        )
    if chi is None:
        chi = bucket_for(max([c.shape[-3] for c in cores]
                             + [c.shape[-1] for c in cores]))
    return MPS(cores=_pad_to_stack(cores, chi),
               ranks=torch.stack([r.to(torch.int32) for r in ranks], dim=-1),
               amplitude=amplitude)


def signal_ztmps(x, *, cutoff: float = 1e-10, maxdim: int = 2**62,
                 chi: int | None = None, method: str = "svd", k: int = 20,
                 p: int = 10, q: int = 0, seed: int = 1234,
                 device=None) -> ZTMPS:
    """Encode a dense signal into the paired-register ZTMPS on ``device``
    (the card unless told otherwise).

    Builds the SignalMPS, then fans out each physical leg onto a
    (main, copy) pair through the copy tensor delta(s, s_main, s_copy) and
    splits it with a truncated SVD, every site in one batched call.
    ``method='cross'`` routes to the host-f64 cross encoder."""
    device = resolve_device(device)
    if method == "cross":
        from qilaplace_tpu_torch.signals.cross_encode import signal_ztmps_cross

        return signal_ztmps_cross(x, cutoff=cutoff,
                                  maxdim=int(min(maxdim, 256)), chi=chi,
                                  seed=seed, device=device)
    psi = signal_mps(x, method=method, cutoff=cutoff, maxdim=maxdim, chi=chi,
                     k=k, p=p, q=q, seed=seed, device=device)
    n, chi_s = psi.n, psi.chi
    # the fan-out split's true rank is up to 2x the incoming bond rank, so
    # the chain is bucketed wider than the signal MPS; a user chi still caps
    chi_c = chi if chi is not None else bucket_for(min(2 * chi_s, maxdim))
    maxdim_eff = min(maxdim, 2 * chi_s, chi_c)

    cores_s = psi.cores
    if chi_c != chi_s:
        padded = cores_s.new_zeros(n, chi_c, 2, chi_c)
        padded[:, :chi_s, :, :chi_s] = cores_s
        cores_s = padded
    # T[l, s_main, s_copy, r] = cores[l, s, r] * delta(s, s_main, s_copy)
    delta = torch.zeros(2, 2, 2, dtype=psi.dtype, device=device)
    delta[0, 0, 0] = 1
    delta[1, 1, 1] = 1
    T = torch.einsum("nlsr,smc->nlmcr", cores_s, delta)

    # every site's split in one call, the sites as its batch (jax.vmap of
    # the split in the JAX package)
    L, R, intra = svd_split(T.reshape(n, chi_c * 2, 2 * chi_c),
                            cutoff=cutoff, maxdim=maxdim_eff,
                            absorb="right", out_dim=chi_c)
    chain_cores = torch.stack(
        [L.reshape(n, chi_c, 2, chi_c), R.reshape(n, chi_c, 2, chi_c)], dim=1
    ).reshape(2 * n, chi_c, 2, chi_c)
    # chain ranks: [1, c_1, b_1, c_2, b_2, ..., c_n, 1]
    chain_ranks = torch.ones(2 * n + 1, dtype=torch.int32, device=device)
    chain_ranks[1: 2 * n: 2] = intra
    chain_ranks[2: 2 * n: 2] = psi.ranks[1:n]
    chain = MPS(cores=chain_cores, ranks=chain_ranks,
                amplitude=psi.amplitude)
    return ZTMPS(chain=chain)
