"""QFT MPO builder.

Counterpart of ``qilaplace_tpu/transforms/qft.py``. The build folds the n
controlled-phase layer MPOs into an identity accumulator, each step a
fused zip-up composition and a canonical polish (ops.apply.compose_layers);
on the card every truncation's eigensolves are K2 launches.

The result is the bit-reversed DFT operator Q_n (site 1 of the output
holds the LSB of the frequency index), with the -2 pi i phase convention
and 1/sqrt(N) normalization; its bond saturates at 8.
"""

from __future__ import annotations

import torch

from qilaplace_tpu_torch.circuits.qft_gates import control_Hphase_mpo
from qilaplace_tpu_torch.core.mpo import MPO, identity_mpo, mpo_repad
from qilaplace_tpu_torch.ops.apply import compose_layers, embed_window, stack_layers
from qilaplace_tpu_torch.utils.config import bucket_for, resolve_device


def build_qft_mpo(n: int, *, cutoff: float = 1e-14, maxdim: int = 1000,
                  chi: int | None = None, dtype=torch.complex128,
                  chi_work: int | None = None, device=None) -> MPO:
    """Build the n-site QFT MPO on ``device`` (the card unless told
    otherwise)."""
    if n < 1:
        raise ValueError(f"build_qft_mpo: n must be >= 1, got {n}")
    device = resolve_device(device)
    if chi is None:
        chi = bucket_for(min(maxdim, 16))  # plateau is 8; sweep headroom
    # no bond of an n-site operator chain can exceed 4^(n//2)
    chi = min(chi, bucket_for(4 ** (n // 2)))
    maxdim = min(maxdim, chi)

    if n == 1:
        return mpo_repad(control_Hphase_mpo(1, dtype=dtype, device=device),
                         chi)
    layers = [
        embed_window(control_Hphase_mpo(n - it, dtype=dtype, device=device),
                     n, it)
        for it in range(n)
    ]
    layer_cores, layer_ranks = stack_layers(layers)
    # sequential prefix fold: mid-segment layer products are not low-rank
    acc = identity_mpo(n, chi=chi, dtype=dtype, device=device)
    return compose_layers(acc, layer_cores, layer_ranks, cutoff=cutoff,
                          maxdim=maxdim, chi_work=chi_work)
