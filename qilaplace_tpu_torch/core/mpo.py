"""Static-shape MPO containers.

Counterpart of ``qilaplace_tpu/core/mpo.py`` (containers,
``mpo_from_traced``, ``mpo_repad``, ``max_bond``, ``identity_mpo`` and
``mpo_to_dense``). A core is
``W[l, s_out, s_in, r]``, stacked and zero-padded as ``cores[n, chi, 2, 2,
chi]`` with int32 ``ranks[n+1]``; ``PairedSiteMPO`` is a thin view of its
interleaved 2n-site chain.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qilaplace_tpu_torch.utils.config import (
    bucket_for,
    resolve_device,
    to_torch_dtype,
)


@dataclasses.dataclass
class MPO:
    """Padded matrix-product operator.

    cores: [n, chi, 2, 2, chi] with axes (left, s_out, s_in, right)
    ranks: [n+1] int32 valid bond dimensions, ranks[0] == ranks[n] == 1

    A stack of operators (``parallel.stack_mpos``) carries the operator
    axis first in both fields.
    """

    cores: torch.Tensor
    ranks: torch.Tensor

    @property
    def n(self) -> int:
        return self.cores.shape[-5]

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

    def to(self, device=None, dtype: torch.dtype | None = None) -> "MPO":
        return MPO(cores=self.cores.to(device=device, dtype=dtype),
                   ranks=self.ranks.to(device=device))

    @staticmethod
    def from_core_list(core_list, chi: int | None = None,
                       *, device=None) -> "MPO":
        """Stack variable-size cores ``[l_i, 2, 2, r_i]`` into a padded MPO
        on ``device`` (the card unless told otherwise)."""
        device = resolve_device(device)
        core_list = [np.asarray(c) for c in core_list]
        n = len(core_list)
        ranks = [1] + [c.shape[3] for c in core_list]
        if core_list[0].shape[0] != 1 or core_list[-1].shape[3] != 1:
            raise ValueError("edge cores must have boundary bond dimension 1")
        if chi is None:
            chi = bucket_for(max(ranks))
        dtype = np.result_type(*[c.dtype for c in core_list])
        cores = np.zeros((n, chi, 2, 2, chi), dtype=dtype)
        for i, c in enumerate(core_list):
            l, so, si, r = c.shape
            if (so, si) != (2, 2):
                raise ValueError("physical dimensions must be 2x2")
            if l != ranks[i] or l > chi or r > chi:
                raise ValueError("core shapes inconsistent with ranks/chi")
            cores[i, :l, :, :, :r] = c
        return MPO(
            cores=torch.from_numpy(cores).to(device),
            ranks=torch.tensor(ranks, dtype=torch.int32, device=device),
        )

    def to_core_list(self) -> list[np.ndarray]:
        cores = self.cores.detach().cpu().numpy()
        ranks = self.ranks.cpu().numpy()
        return [
            cores[i, : ranks[i], :, :, : ranks[i + 1]] for i in range(self.n)
        ]


SingleSiteMPO = MPO


@dataclasses.dataclass
class PairedSiteMPO:
    """Paired-register MPO = interleaved 2n-site chain view."""

    chain: MPO

    @property
    def n(self) -> int:
        return self.chain.n // 2

    def __len__(self) -> int:
        return self.n

    def to(self, device=None, dtype: torch.dtype | None = None):
        return PairedSiteMPO(chain=self.chain.to(device, dtype))


def _mpo_chain(W) -> MPO:
    return W.chain if isinstance(W, PairedSiteMPO) else W


def _mpo_rewrap(W, chain: MPO):
    return PairedSiteMPO(chain=chain) if isinstance(W, PairedSiteMPO) else chain


def identity_mpo(n: int, *, chi: int = 1, dtype=torch.complex64,
                 paired: bool = False, device=None):
    """Identity operator on n sites (2n chain sites if ``paired``), on
    ``device`` (the card unless told otherwise)."""
    n_chain = 2 * n if paired else n
    eye = np.zeros((1, 2, 2, 1))
    eye[0, :, :, 0] = np.eye(2)
    W = MPO.from_core_list([eye] * n_chain, chi=chi, device=device)
    W = MPO(cores=W.cores.to(to_torch_dtype(dtype)), ranks=W.ranks)
    return PairedSiteMPO(chain=W) if paired else W


def mpo_to_dense(W) -> torch.Tensor:
    """Dense operator matrix [2^n, 2^n] with site 1 = most significant bit
    on both the row (s_out) and column (s_in) index. Small n only."""
    m = _mpo_chain(W)
    n = m.n
    T = m.cores[0][0]  # [2, 2, chi]
    for i in range(1, n):
        T = torch.tensordot(T, m.cores[i], dims=([T.dim() - 1], [0]))
    T = T[..., 0]  # axes: o1, i1, o2, i2, ...
    perm = [2 * i for i in range(n)] + [2 * i + 1 for i in range(n)]
    return T.permute(*perm).reshape(2**n, 2**n)


def mpo_from_traced(core_list, chi: int | None = None) -> MPO:
    """Stack torch cores ``[l_i, 2, 2, r_i]`` into a padded MPO on their
    device (the gate builders make their cores there, parameterized by the
    damping wr); ranks come from the shapes."""
    ranks = [1] + [int(c.shape[3]) for c in core_list]
    if core_list[0].shape[0] != 1 or core_list[-1].shape[3] != 1:
        raise ValueError("edge cores must have boundary bond dimension 1")
    if chi is None:
        chi = bucket_for(max(ranks))
    first = core_list[0]
    cores = first.new_zeros(len(core_list), chi, 2, 2, chi)
    for i, c in enumerate(core_list):
        cores[i, : c.shape[0], :, :, : c.shape[3]] = c
    return MPO(cores=cores,
               ranks=torch.tensor(ranks, dtype=torch.int32,
                                  device=first.device))


def mpo_repad(W, chi_new: int):
    """Re-pad MPO bonds to a new static bucket (see core.mps.repad)."""
    from qilaplace_tpu_torch.core.mps import _check_shrink

    m = _mpo_chain(W)
    chi = m.chi
    if chi_new == chi:
        return W
    if chi_new > chi:
        cores = torch.zeros(m.n, chi_new, 2, 2, chi_new, dtype=m.dtype,
                            device=m.device)
        cores[:, :chi, :, :, :chi] = m.cores
    else:
        _check_shrink(m.cores, m.ranks, chi_new, "mpo_repad")
        cores = m.cores[:, :chi_new, :, :, :chi_new].contiguous()
    ranks = torch.clamp(m.ranks, max=chi_new)
    return _mpo_rewrap(W, MPO(cores=cores, ranks=ranks))


def max_bond(obj) -> int:
    """Largest valid bond dimension (the key model metric)."""
    chain = getattr(obj, "chain", obj)
    return int(chain.ranks.max())
