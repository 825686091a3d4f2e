"""Static-shape MPS containers.

Counterpart of ``qilaplace_tpu/core/mps.py``: containers and their
index helpers (``siteindices``, ``bondindices``, ``nsite``), ``validate``,
``repad``, the coefficient readouts, the dense readout and norm, and the
canonicalizing and compressing sweeps (``lax.scan`` there, Python loops
here; truncation is mask-based, ops/truncation.py).
Layout is the JAX package's: all site tensors in one zero-padded stack
``cores[n, chi, 2, chi]``, valid bond dimensions in ``ranks[n+1]`` (int32,
``ranks[0] == ranks[n] == 1``) and the original signal 2-norm in
``amplitude``. ``ZTMPS`` is a thin view of its interleaved 2n-site chain
[main_1, copy_1, main_2, copy_2, ...].

A batch of states is one container whose every field carries the leading
batch axis (``cores [B, n, chi, 2, chi]``, ``ranks [B, n+1]``,
``amplitude [B]``), the layout ``jax.vmap`` gives the JAX package's
containers; ``coefficient_batch`` and the two-site sweep take it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qilaplace_tpu_torch.ops.complexlinalg import slot_einsum
from qilaplace_tpu_torch.ops.truncation import svd_split
from qilaplace_tpu_torch.utils.config import (
    bucket_for,
    real_dtype,
    resolve_device,
)


@dataclasses.dataclass
class MPS:
    """Padded matrix-product state.

    cores:     [n, chi, 2, chi] (complex or real)
    ranks:     [n+1] int32, valid bond dimensions
    amplitude: scalar, the original signal 2-norm (the tensor data is
               unit-norm after encoding)

    A batch of B states carries B first in every field.
    """

    cores: torch.Tensor
    ranks: torch.Tensor
    amplitude: torch.Tensor

    @property
    def n(self) -> int:
        return self.cores.shape[-4]

    @property
    def chi(self) -> int:
        return self.cores.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.cores.dtype

    @property
    def device(self) -> torch.device:
        return self.cores.device

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, config):
        """``psi[b1, b2, ...]``: the amplitude at one bit configuration,
        read by :func:`coefficient` on the state's device."""
        if isinstance(config, tuple):
            config = list(config)
        return coefficient(self, config)

    def to(self, device=None, dtype: torch.dtype | None = None) -> "MPS":
        """Copy to ``device`` and/or cast the cores to ``dtype`` (the
        amplitude takes the real dtype of the same width)."""
        amp_dtype = None if dtype is None else real_dtype(dtype)
        return MPS(
            cores=self.cores.to(device=device, dtype=dtype),
            ranks=self.ranks.to(device=device),
            amplitude=self.amplitude.to(device=device, dtype=amp_dtype),
        )

    @staticmethod
    def from_core_list(core_list, amplitude=1.0, chi: int | None = None,
                       *, device=None) -> "MPS":
        """Stack variable-size cores ``[l_i, 2, r_i]`` into a padded MPS on
        ``device`` (the card unless told otherwise)."""
        device = resolve_device(device)
        core_list = [np.asarray(c) for c in core_list]
        n = len(core_list)
        ranks = [1] + [c.shape[2] for c in core_list]
        if core_list[0].shape[0] != 1 or core_list[-1].shape[2] != 1:
            raise ValueError("edge cores must have boundary bond dimension 1")
        if chi is None:
            chi = bucket_for(max(ranks))
        dtype = np.result_type(*[c.dtype for c in core_list])
        cores = np.zeros((n, chi, 2, chi), dtype=dtype)
        for i, c in enumerate(core_list):
            l, s, r = c.shape
            if s != 2:
                raise ValueError("site dimension must be 2")
            if l != ranks[i] or l > chi or r > chi:
                raise ValueError("core shapes inconsistent with ranks/chi")
            cores[i, :l, :, :r] = c
        return MPS(
            cores=torch.from_numpy(cores).to(device),
            ranks=torch.tensor(ranks, dtype=torch.int32, device=device),
            amplitude=torch.as_tensor(np.asarray(amplitude), device=device),
        )

    def to_core_list(self) -> list[np.ndarray]:
        """Unpadded cores as numpy arrays, for tests and interop."""
        cores = self.cores.detach().cpu().numpy()
        ranks = self.ranks.cpu().numpy()
        return [cores[i, : ranks[i], :, : ranks[i + 1]] for i in range(self.n)]

    @staticmethod
    def empty(n: int, *, chi: int = 8, dtype: torch.dtype = torch.complex64,
              amplitude=1.0, device=None) -> "MPS":
        """Zero cores ``[n, chi, 2, chi]`` with every bond rank 1 on
        ``device`` (the card unless told otherwise), ready to be filled
        site by site."""
        if n < 1:
            raise ValueError("MPS.empty: need n >= 1")
        device = resolve_device(device)
        return MPS(
            cores=torch.zeros(n, chi, 2, chi, dtype=dtype, device=device),
            ranks=torch.ones(n + 1, dtype=torch.int32, device=device),
            amplitude=torch.as_tensor(np.asarray(amplitude), device=device),
        )


# SignalMPS is the single-register MPS.
SignalMPS = MPS


@dataclasses.dataclass
class ZTMPS:
    """Paired-register MPS stored as its interleaved 2n-site chain."""

    chain: MPS

    @property
    def n(self) -> int:
        return self.chain.n // 2

    @property
    def amplitude(self) -> torch.Tensor:
        return self.chain.amplitude

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, config):
        """``psi[m1, c1, m2, c2, ...]``: the amplitude at one chain-length
        configuration of interleaved main and copy bits."""
        if isinstance(config, tuple):
            config = list(config)
        return coefficient(self, config)

    def to(self, device=None, dtype: torch.dtype | None = None) -> "ZTMPS":
        return ZTMPS(chain=self.chain.to(device, dtype))

    @staticmethod
    def empty(n: int, *, chi: int = 8, dtype: torch.dtype = torch.complex64,
              amplitude=1.0, device=None) -> "ZTMPS":
        """Zero paired-register state: :meth:`MPS.empty` of the 2n-site
        chain."""
        return ZTMPS(chain=MPS.empty(2 * n, chi=chi, dtype=dtype,
                                     amplitude=amplitude, device=device))


def _chain(psi) -> MPS:
    return psi.chain if isinstance(psi, ZTMPS) else psi


def _rewrap(psi, chain: MPS):
    return ZTMPS(chain=chain) if isinstance(psi, ZTMPS) else chain


def siteindices(psi):
    """Positional site index lists ``(main, copy)``: chain positions of the
    main and copy register sites (copy is empty for a single register)."""
    if isinstance(psi, ZTMPS):
        n = psi.n
        return (list(range(0, 2 * n, 2)), list(range(1, 2 * n, 2)))
    return (list(range(psi.n)), [])


def bondindices(psi):
    """Positional bond index lists ``(main, copy)``: chain bond b sits
    between chain sites b and b+1."""
    if isinstance(psi, ZTMPS):
        n = psi.n
        return (list(range(1, 2 * n - 1, 2)), list(range(0, 2 * n, 2)))
    return (list(range(psi.n - 1)), [])


def nsite(psi) -> int:
    """Deprecated alias for ``len(psi)``."""
    import warnings

    warnings.warn("nsite is deprecated; use len(psi)", DeprecationWarning,
                  stacklevel=2)
    return len(psi)


def validate(obj, *, atol: float | None = None) -> None:
    """Structural validation of MPS, ZTMPS, MPO and PairedSiteMPO: ranks
    within [1, chi], boundary ranks 1, padding (numerically) zero outside
    the valid blocks, paired chains of even length. ``atol`` defaults to
    64 * eps * max|core|. Raises ValueError on a violation."""
    from qilaplace_tpu_torch.core.mpo import MPO, PairedSiteMPO, _mpo_chain

    if isinstance(obj, (MPO, PairedSiteMPO)):
        m = _mpo_chain(obj)
        paired = isinstance(obj, PairedSiteMPO)
    else:
        m = _chain(obj)
        paired = isinstance(obj, ZTMPS)
    cores = m.cores.detach().cpu().numpy()
    ranks = m.ranks.cpu().numpy()
    n, chi = m.n, m.chi
    if atol is None:
        scale = float(np.abs(cores).max()) if cores.size else 0.0
        atol = 64.0 * float(np.finfo(cores.real.dtype).eps) * scale
    if paired and n % 2 != 0:
        raise ValueError(
            "validate: paired-register chains must have an even number of sites"
        )
    if ranks.shape != (n + 1,):
        raise ValueError(f"validate: ranks must have length n+1={n + 1}")
    if ranks[0] != 1 or ranks[n] != 1:
        raise ValueError("validate: boundary ranks must be 1")
    if (ranks < 1).any() or (ranks > chi).any():
        raise ValueError("validate: ranks out of [1, chi]")
    for i in range(n):
        c = np.abs(cores[i])
        pad = max(
            c[ranks[i]:].max() if ranks[i] < chi else 0.0,
            c[..., ranks[i + 1]:].max() if ranks[i + 1] < chi else 0.0,
        )
        if pad > atol:
            raise ValueError(
                f"validate: nonzero padding at site {i} (max {pad:.2e})"
            )


# ------------------------------- coefficient -------------------------------

def _parse_config(psi, config) -> torch.Tensor:
    """Bit configuration from an int sequence/tensor, a bit string like
    "0101" or "[1,0,1]", or a non-negative integer read as big-endian bits."""
    n = _chain(psi).n
    if isinstance(config, torch.Tensor):
        return config
    if isinstance(config, str):
        stripped = config.strip().strip("[](){}")
        if not stripped:
            raise ValueError("coefficient: configuration string is empty")
        if any(c in stripped for c in ", \t"):
            bits = [int(t) for t in stripped.replace(",", " ").split()]
        else:
            if not set(stripped) <= {"0", "1"}:
                raise ValueError(
                    "coefficient: bit strings may contain only '0' or '1'"
                )
            bits = [int(c) for c in stripped]
        return torch.tensor(bits)
    if isinstance(config, (int, np.integer)):
        if config < 0:
            raise ValueError("coefficient: integer configuration must be >= 0")
        if config >> n:
            raise ValueError(
                f"coefficient: integer {config} requires more than {n} bits"
            )
        return torch.tensor([(int(config) >> (n - 1 - i)) & 1
                             for i in range(n)])
    return torch.as_tensor(np.asarray(config))


def coefficient(psi, config) -> torch.Tensor:
    """Amplitude <config|psi> for one zero-based bit configuration (chain
    length for a ZTMPS: interleaved main/copy bits)."""
    m = _chain(psi)
    bits = _parse_config(psi, config).tolist()
    v = torch.zeros(m.chi, dtype=m.dtype, device=m.device)
    v[0] = 1
    for site, bit in enumerate(bits):
        v = v @ m.cores[site, :, int(bit), :]
    return m.amplitude * v[0]


def coefficient_batch(psi, configs) -> torch.Tensor:
    """Batched coefficient: ``configs`` [B, n] -> [B] amplitudes; at every
    site both branch products are formed and each row keeps its bit's. A
    batch of states [S, ...] gives [S, B], as ``jax.vmap`` over the state
    does."""
    m = _chain(psi)
    configs = torch.as_tensor(configs, device=m.device)
    B = configs.shape[0]
    lead = m.cores.shape[:-4]
    v = torch.zeros(*lead, B, m.chi, dtype=m.dtype, device=m.device)
    v[..., 0] = 1
    for site in range(m.n):
        core = m.cores.select(-4, site)
        sel = (configs[:, site] == 0)[:, None]
        v = torch.where(sel, v @ core[..., 0, :], v @ core[..., 1, :])
    return m.amplitude[..., None] * v[..., 0]


# ------------------------------ chi repadding ------------------------------

def _check_shrink(cores, ranks, chi_new: int, what: str) -> None:
    """Repad shrinks may only slice away zeros, and ranks must fit."""
    r = int(ranks.max())
    if r > chi_new:
        raise ValueError(
            f"{what}: cannot shrink to chi={chi_new}; max rank is {r}"
        )
    c = cores.abs()
    sliced = max(
        float(c[:, chi_new:].max()) if c[:, chi_new:].numel() else 0.0,
        float(c[..., chi_new:].max()) if c[..., chi_new:].numel() else 0.0,
    )
    # sweeps can leave sub-roundoff residue in the padding; only data counts
    scale = float(c.max()) if c.numel() else 0.0
    eps = torch.finfo(real_dtype(cores.dtype)).eps
    if sliced > 64 * eps * scale:
        raise ValueError(
            f"{what}: shrinking to chi={chi_new} would discard nonzero data "
            f"(max |entry| {sliced:.2e}); valid data is not in the leading "
            "block"
        )


def repad(psi, chi_new: int):
    """Re-pad all bonds to a new static bucket. Shrinking requires the
    valid data to sit in the leading chi_new block (checked)."""
    m = _chain(psi)
    n, chi = m.n, m.chi
    if chi_new == chi:
        return psi
    if chi_new > chi:
        cores = torch.zeros(n, chi_new, 2, chi_new, dtype=m.dtype,
                            device=m.device)
        cores[:, :chi, :, :chi] = m.cores
    else:
        _check_shrink(m.cores, m.ranks, chi_new, "repad")
        cores = m.cores[:, :chi_new, :, :chi_new].contiguous()
    ranks = torch.clamp(m.ranks, max=chi_new)
    return _rewrap(psi, MPS(cores=cores, ranks=ranks, amplitude=m.amplitude))


# ------------------------------ dense readout ------------------------------

def mps_to_vector(psi, *, reverse: bool = False) -> torch.Tensor:
    """Full dense vector (small n only: materializes 2^n entries).

    reverse=False: natural order (site 1 = MSB, matching the input signal).
    reverse=True: raw bit-reversed order (the native output order of the
    QFT / DT / zT operators).
    """
    m = _chain(psi)
    n = m.n
    T = m.cores[0][0]  # [2, chi]
    for i in range(1, n):
        T = torch.tensordot(T, m.cores[i], dims=([T.dim() - 1], [0]))
    T = T[..., 0]  # [2]*n, axis i = site i
    if reverse:
        T = T.permute(*range(n - 1, -1, -1))
    return T.reshape(-1) * m.amplitude


def norm(psi) -> torch.Tensor:
    """Euclidean norm sqrt(<psi|psi>) of the tensor data (the stored
    amplitude excluded)."""
    m = _chain(psi)
    E = torch.zeros(m.chi, m.chi, dtype=m.dtype, device=m.device)
    E[0, 0] = 1
    for core in m.cores:
        E = torch.einsum("ab,asr,bsq->rq", E, core.conj(), core)
    return torch.sqrt(E[0, 0].abs())


# ------------------------------ canonicalize -------------------------------

def _sweep_right(cores, ranks, *, cutoff, maxdim, start: int, stop: int):
    """Left-orthogonalize sites [start, stop): SVD-split each core and
    absorb the remainder into the next site. Returns (cores, ranks)."""
    chi = cores.shape[1]
    maxdim = min(maxdim, chi)
    if stop - start < 1:
        return cores, ranks
    R = torch.eye(chi, dtype=cores.dtype, device=cores.device)
    new, seg_ranks = [], []
    for i in range(start, stop):
        core = torch.einsum("ab,bsr->asr", R, cores[i])
        p = core.shape[1]
        Q, R, rank = svd_split(core.reshape(chi * p, chi), cutoff=cutoff,
                               maxdim=maxdim, absorb="right", out_dim=chi)
        new.append(Q.reshape(chi, p, chi))
        seg_ranks.append(rank)
    cores = cores.clone()
    cores[start:stop] = torch.stack(new)
    cores[stop] = torch.einsum("ab,bsr->asr", R, cores[stop])
    ranks = ranks.clone()
    ranks[start + 1: stop + 1] = torch.stack(seg_ranks)
    return cores, ranks


def _sweep_left(cores, ranks, *, cutoff, maxdim, start: int, stop: int):
    """Right-orthogonalize sites (stop, start] sweeping right to left; the
    remainder is absorbed into site stop."""
    chi = cores.shape[1]
    maxdim = min(maxdim, chi)
    if start - stop < 1:
        return cores, ranks
    L = torch.eye(chi, dtype=cores.dtype, device=cores.device)
    new, seg_ranks = {}, {}
    for i in range(start, stop, -1):
        core = torch.einsum("lsb,ba->lsa", cores[i], L)
        p = core.shape[1]
        L, Q, rank = svd_split(core.reshape(chi, p * chi), cutoff=cutoff,
                               maxdim=maxdim, absorb="left", out_dim=chi)
        new[i] = Q.reshape(chi, p, chi)
        seg_ranks[i] = rank
    idx = range(stop + 1, start + 1)
    cores = cores.clone()
    cores[stop + 1: start + 1] = torch.stack([new[i] for i in idx])
    cores[stop] = torch.einsum("lsb,ba->lsa", cores[stop], L)
    ranks = ranks.clone()
    ranks[stop + 1: start + 1] = torch.stack([seg_ranks[i] for i in idx])
    return cores, ranks


def canonicalize(psi, direction: str, *, center: int | None = None,
                 cutoff: float = 1e-12, maxdim: int | None = None):
    """Bring the MPS into canonical form.

    direction='right': left-canonical up to ``center`` (default last site);
    direction='left':  right-canonical down to ``center`` (default site 0).
    Truncation uses the SVD-with-cutoff semantics of ops/truncation.py.
    """
    m = _chain(psi)
    n, chi = m.n, m.chi
    if maxdim is None:
        maxdim = chi
    if direction == "right":
        c = n - 1 if center is None else center
        cores, ranks = _sweep_right(m.cores, m.ranks, cutoff=cutoff,
                                    maxdim=maxdim, start=0, stop=c)
    elif direction == "left":
        c = 0 if center is None else center
        cores, ranks = _sweep_left(m.cores, m.ranks, cutoff=cutoff,
                                   maxdim=maxdim, start=n - 1, stop=c)
    else:
        raise ValueError("direction must be 'right' or 'left'")
    return _rewrap(psi, MPS(cores=cores, ranks=ranks, amplitude=m.amplitude))


# -------------------------------- compress ---------------------------------

def _two_site_sweep(cores, ranks, *, cutoff, maxdim, reverse: bool):
    """One truncating two-site SVD sweep (left to right unless
    ``reverse``). Generic in the physical dimension p (2 for MPS chains,
    4 for MPO chains with fused (s_out, s_in) legs). Leading batch axes of
    ``cores`` [..., n, chi, p, chi] and ``ranks`` [..., n+1] ride every
    split, so a batch takes one eigensolve call per split."""
    n, chi, p = cores.shape[-4], cores.shape[-3], cores.shape[-2]
    lead = cores.shape[:-4]
    maxdim = min(maxdim, chi)
    bond_ranks = [None] * (n - 1)
    out = [None] * n
    site = lambda i: cores.select(-4, i)  # noqa: E731
    if not reverse:
        left = site(0)
        for i in range(1, n):
            T = slot_einsum("...lsa,...atr->...lstr", left, site(i),
                            core=3)
            L, R, rank = svd_split(T.reshape(*lead, chi * p, p * chi),
                                   cutoff=cutoff, maxdim=maxdim,
                                   absorb="right", out_dim=chi)
            out[i - 1] = L.reshape(*lead, chi, p, chi)
            bond_ranks[i - 1] = rank
            left = R.reshape(*lead, chi, p, chi)
        out[n - 1] = left
    else:
        right = site(n - 1)
        for i in range(n - 2, -1, -1):
            T = slot_einsum("...lsa,...atr->...lstr", site(i), right,
                            core=3)
            L, R, rank = svd_split(T.reshape(*lead, chi * p, p * chi),
                                   cutoff=cutoff, maxdim=maxdim,
                                   absorb="left", out_dim=chi)
            out[i + 1] = R.reshape(*lead, chi, p, chi)
            bond_ranks[i] = rank
            right = L.reshape(*lead, chi, p, chi)
        out[0] = right
    ranks = ranks.clone()
    if n > 1:
        ranks[..., 1:n] = torch.stack(bond_ranks, dim=-1)
    return torch.stack(out, dim=-4), ranks


def compress(psi, *, maxdim: int | None = None, tol: float = 1e-12,
             sweeps: int = 1):
    """Truncate bond dimensions by alternating two-site SVD sweeps and
    renormalize, absorbing the norm into ``amplitude`` (per-bond cutoff
    budget tol^2 / ((n - 1) sweeps))."""
    m = _chain(psi)
    n, chi = m.n, m.chi
    if n < 2:
        raise ValueError("compress: MPS must have at least 2 sites")
    if maxdim is None:
        maxdim = chi
    cutoff = tol**2 / ((n - 1) * sweeps)

    out = canonicalize(m, "left")
    cores, ranks = out.cores, out.ranks
    for _ in range(sweeps):
        cores, ranks = _two_site_sweep(cores, ranks, cutoff=cutoff,
                                       maxdim=maxdim, reverse=False)
        cores, ranks = _two_site_sweep(cores, ranks, cutoff=cutoff,
                                       maxdim=maxdim, reverse=True)
    out = canonicalize(MPS(cores=cores, ranks=ranks, amplitude=m.amplitude),
                       "left")
    nrm = norm(out)
    safe = torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    cores = out.cores.clone()
    cores[0] = cores[0] * (1.0 / safe).to(out.dtype)
    amplitude = torch.where(nrm == 0, m.amplitude,
                            m.amplitude * nrm.to(m.amplitude.dtype))
    return _rewrap(psi, MPS(cores=cores, ranks=out.ranks, amplitude=amplitude))
