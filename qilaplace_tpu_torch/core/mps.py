"""Static-shape MPS containers.

Counterpart of ``qilaplace_tpu/core/mps.py`` (containers, ``validate``,
``repad`` and the coefficient readouts; the sweeps are not ported yet).
Layout is the JAX package's: all site tensors in one zero-padded stack
``cores[n, chi, 2, chi]``, valid bond dimensions in ``ranks[n+1]`` (int32,
``ranks[0] == ranks[n] == 1``) and the original signal 2-norm in
``amplitude``. ``ZTMPS`` is a thin view of its interleaved 2n-site chain
[main_1, copy_1, main_2, copy_2, ...].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qilaplace_tpu_torch.utils.config import bucket_for, real_dtype


@dataclasses.dataclass
class MPS:
    """Padded matrix-product state.

    cores:     [n, chi, 2, chi] (complex or real)
    ranks:     [n+1] int32, valid bond dimensions
    amplitude: scalar, the original signal 2-norm (the tensor data is
               unit-norm after encoding)
    """

    cores: torch.Tensor
    ranks: torch.Tensor
    amplitude: torch.Tensor

    @property
    def n(self) -> int:
        return self.cores.shape[0]

    @property
    def chi(self) -> int:
        return self.cores.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.cores.dtype

    @property
    def device(self) -> torch.device:
        return self.cores.device

    def __len__(self) -> int:
        return self.n

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
                       *, device="cpu") -> "MPS":
        """Stack variable-size cores ``[l_i, 2, r_i]`` into a padded MPS."""
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

    def to(self, device=None, dtype: torch.dtype | None = None) -> "ZTMPS":
        return ZTMPS(chain=self.chain.to(device, dtype))


def _chain(psi) -> MPS:
    return psi.chain if isinstance(psi, ZTMPS) else psi


def _rewrap(psi, chain: MPS):
    return ZTMPS(chain=chain) if isinstance(psi, ZTMPS) else chain


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
    site both branch products are formed and each row keeps its bit's."""
    m = _chain(psi)
    configs = torch.as_tensor(configs, device=m.device)
    B = configs.shape[0]
    v = torch.zeros(B, m.chi, dtype=m.dtype, device=m.device)
    v[:, 0] = 1
    for site in range(m.n):
        core = m.cores[site]
        sel = (configs[:, site] == 0)[:, None]
        v = torch.where(sel, v @ core[:, 0, :], v @ core[:, 1, :])
    return m.amplitude * v[:, 0]


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
