"""Host-f64 signal encoders via TT cross-interpolation (``method='cross'``).

Counterpart of ``qilaplace_tpu/signals/cross_encode.py``, copied as host
numpy so that pivots, ranks and cores match the JAX package exactly; only
the finished containers are torch tensors, placed on ``device``.

Cross-interpolation (nested maxvol pivots, transforms/analytic.cross_tt)
reads only O(n * r^2) entries of the 2^n-sample signal; the result is
validated against fresh random entries and retried with escalated
rank/sweeps if the sampled error misses the bar. Works on a materialized
vector or on a callable ``f(idx) -> values`` with an ``n_bits`` attribute
(nothing of size 2^n is ever formed).
"""

from __future__ import annotations

import numpy as np

from qilaplace_tpu_torch.core.mps import MPS, ZTMPS
from qilaplace_tpu_torch.transforms.analytic import (
    _compress_host,
    _validate_cross,
    cross_tt,
)
from qilaplace_tpu_torch.utils.config import resolve_device, to_torch_dtype


def _bit_sampler(n: int):
    """Uniform random bit-configs (site 0 = MSB of the sample index)."""

    def sampler(rng, B):
        return rng.integers(0, 2, (B, n)).astype(np.int64)

    return sampler


class _EntryKernel:
    """Signal entries as a d=2 cross kernel with factorized block
    evaluation: the sample index decomposes additively over sites
    (idx = idx_prefix + bit * 2^{n-1-s} + idx_suffix), so a
    prefix x {0,1} x suffix block needs two tiny bit-weight sums and one
    vectorized gather/evaluation — no per-row index matvecs.

    ``scale`` multiplies the gathered entries — normalization happens
    HERE, on the O(n r^2) entries the cross actually reads, never as a
    full-vector divide (an 8 GiB temporary + 2^n flops at n = 30)."""

    d = 2

    def __init__(self, x, n: int, scale: float = 1.0):
        self.n, self.scale = n, scale
        if callable(x):
            self._fetch = lambda idx: np.asarray(x(idx), dtype=np.float64)
        else:
            xv = np.asarray(x)
            self._fetch = lambda idx: xv[idx]

    def _idx(self, part: np.ndarray, lo: int) -> np.ndarray:
        part = np.asarray(part, dtype=np.int64)
        w = part.shape[1]
        if w == 0:
            return np.zeros(part.shape[0], dtype=np.int64)
        return part @ (1 << (self.n - 1 - lo - np.arange(w, dtype=np.int64)))

    def __call__(self, cfg: np.ndarray) -> np.ndarray:
        return self.scale * self._fetch(self._idx(cfg, 0))

    def block(self, prefixes: np.ndarray, suffixes: np.ndarray) -> np.ndarray:
        s = prefixes.shape[1]
        iv = np.arange(2, dtype=np.int64) << (self.n - 1 - s)
        idx = (
            self._idx(prefixes, 0)[:, None, None]
            + iv[None, :, None]
            + self._idx(suffixes, s + 1)[None, None, :]
        )
        return self.scale * self._fetch(idx)


def _as_entry_fn(x, n: int, scale: float = 1.0):
    """Wrap a vector (or callable on integer indices) as f(cfg [B, n])
    with the factorized ``block`` fast path (see :class:`_EntryKernel`)."""
    return _EntryKernel(x, n, scale)


def _chunked_norm(xv: np.ndarray) -> float:
    """Single-pass Euclidean norm in bounded chunks (no 2^n temporary)."""
    acc = 0.0
    step = 1 << 24
    for lo in range(0, xv.shape[0], step):
        c = xv[lo : lo + step]
        acc += float(np.dot(c, c))
    return float(np.sqrt(acc))


def _cross_cores(f, n, *, cutoff, maxdim, seed, tol):
    """Cross the signal with a validate-and-retry ladder: the internal rank
    rule runs 1e-4 tighter than the target cutoff (the final deterministic
    compression sweep owns the cutoff-level truncation)."""
    sampler = _bit_sampler(n)
    inner = max(cutoff * 1e-4, 1e-28)
    last = None
    # rung 0 at sweeps=2 lands on every measured signal family (smooth
    # closed forms AND random vectors); rung 1 escalates sweeps with the
    # same seed (a seed bump on a marginal pool can make it worse — see
    # transforms.analytic._cross_rail); later rungs bump the seed
    for sw, md, ds in [(2, maxdim, 0), (3, maxdim, 0),
                       (5, maxdim, 7919), (6, 2 * maxdim, 2 * 7919)]:
        s = seed + ds
        cores, _ = cross_tt(
            f, n, d=2, cutoff=inner, maxdim=md, sweeps=sw, seed=s,
            paired=False, sampler=sampler,
        )
        try:
            _validate_cross(f, cores, n, False, s, tol, "signal_cross",
                            sampler=sampler)
            return _compress_host(cores, cutoff, maxdim)
        except RuntimeError as e:
            last = e
    raise RuntimeError(f"signal_cross failed after escalation: {last}")


def _fan_out_pairs(cores):
    """Exact |s> -> |s_main>|s_copy> fan-out of every site (host analogue of
    the vmapped device fan-out, signals/encode.py signal_ztmps): each core
    T[l, s, r] becomes a (main, copy) pair with intra-pair bond (s, r)."""
    out = []
    for T in cores:
        l, _, r = T.shape
        A = np.zeros((l, 2, 2 * r), dtype=T.dtype)
        A[:, 0, :r] = T[:, 0, :]
        A[:, 1, r:] = T[:, 1, :]
        B = np.zeros((2 * r, 2, r), dtype=T.dtype)
        B[:r, 0] = np.eye(r, dtype=T.dtype)
        B[r:, 1] = np.eye(r, dtype=T.dtype)
        out.extend([A, B])
    return out


def _norm_from_chain(cores) -> float:
    """Chain 2-norm via the transfer zipper (cores need not be canonical)."""
    E = np.ones((1, 1))
    for T in cores:
        B = np.einsum("lsr,lsk->rk", np.conj(T), np.einsum("lk,ksr->lsr", E, T))
        E = B
    return float(np.sqrt(np.abs(E[0, 0])))


def _host_cores_and_amp(x, *, cutoff, maxdim, seed, validate_tol):
    if callable(x):
        n = getattr(x, "n_bits", None)
        if n is None:
            raise ValueError(
                "signal cross encode: callable signals need an `n_bits` "
                "attribute giving the quantics depth"
            )
        f = _as_entry_fn(x, n)
        amp = None  # normalized post-hoc from the chain itself
    else:
        xv = np.asarray(x, dtype=np.float64)
        N = xv.shape[0]
        n = max(1, (N - 1).bit_length())
        if N < 2**n:
            xv = np.pad(xv, (0, 2**n - N))
        amp = _chunked_norm(xv)
        f = _as_entry_fn(xv, n, scale=1.0 / (amp if amp else 1.0))
    tol = validate_tol if validate_tol is not None else max(
        1e-7, 20.0 * float(np.sqrt(n * cutoff))
    )
    cores = _cross_cores(f, n, cutoff=cutoff, maxdim=maxdim, seed=seed,
                         tol=tol)
    if amp is None:
        amp = _norm_from_chain(cores)
        cores[0] = cores[0] / (amp if amp else 1.0)
    return cores, amp, n


def _out_dtype(x, dtype):
    """Output dtype rule: explicit ``dtype`` wins; array inputs keep their
    own dtype (encode f32 signals as f32 and let complex MPOs upcast on
    contact); callables stay host-f64 (every arithmetic step of the cross
    ran in f64 anyway). Returns a torch dtype or None."""
    if dtype is not None or callable(x):
        return None if dtype is None else to_torch_dtype(dtype)
    d = getattr(x, "dtype", None)
    kind = np.dtype(d) if d is not None else np.asarray(x).dtype
    return to_torch_dtype(kind) if kind.kind in "fc" else None


def _place(chain: MPS, dtype, device) -> MPS:
    """Cast the cores of the f64 host chain to ``dtype`` (if given) and
    move the chain to ``device``; the amplitude stays f64, as in the JAX
    package."""
    return MPS(cores=chain.cores.to(dtype=dtype).to(device),
               ranks=chain.ranks.to(device),
               amplitude=chain.amplitude.to(device))


def signal_mps_cross(
    x,
    *,
    cutoff: float = 1e-10,
    maxdim: int = 256,
    chi: int | None = None,
    seed: int = 1234,
    validate_tol: float | None = None,
    dtype=None,
    device=None,
) -> MPS:
    """Encode a signal into a SignalMPS by cross-interpolation (host f64).

    ``x``: vector (any length; zero-filled to 2^n) or callable on integer
    sample indices with an ``n_bits`` attribute. Same cutoff semantics and
    container layout as ``signal_mps``; see the module docstring for why
    this route exists. The cores are cast to ``dtype`` on the host and
    placed on ``device`` (the card unless told otherwise).
    """
    device = resolve_device(device)
    cores, amp, _ = _host_cores_and_amp(
        x, cutoff=cutoff, maxdim=maxdim, seed=seed, validate_tol=validate_tol
    )
    return _place(MPS.from_core_list(cores, amplitude=amp, chi=chi,
                                     device="cpu"),
                  _out_dtype(x, dtype), device)


def signal_ztmps_cross(
    x,
    *,
    cutoff: float = 1e-10,
    maxdim: int = 256,
    chi: int | None = None,
    seed: int = 1234,
    validate_tol: float | None = None,
    dtype=None,
    device=None,
) -> ZTMPS:
    """Encode a signal into the paired-register ZTMPS by cross-interpolation
    + exact fan-out + one deterministic compression sweep (host f64); the
    chain lands on ``device`` (the card unless told otherwise)."""
    device = resolve_device(device)
    cores, amp, _ = _host_cores_and_amp(
        x, cutoff=cutoff, maxdim=maxdim, seed=seed, validate_tol=validate_tol
    )
    pair = _compress_host(_fan_out_pairs(cores), cutoff, maxdim)
    chain = MPS.from_core_list(pair, amplitude=amp, chi=chi, device="cpu")
    return ZTMPS(chain=_place(chain, _out_dtype(x, dtype), device))
