"""Damping-transform MPO builder.

Counterpart of ``qilaplace_tpu/transforms/dt.py``. Two parts: Part 1, the
control_damping blocks (control on main_k) for k = 1..n; Part 2, the
control_damping_copy blocks (control on copy_k) for k = 1..n-1. Every
block is embedded into the full padded 2n chain and the stack is folded
into an identity accumulator by fused compositions
(ops.apply.compose_layers); on the card every truncation's eigensolves are
K2 launches.

Semantics: DT |j>|j> = (1/sqrt N) sum_k e^{-wr k j / N} |k_rev>|j> (the
output main register is bit-reversed, LSB-first). The bond plateaus near
17-18.
"""

from __future__ import annotations

import torch

from qilaplace_tpu_torch.circuits.dt_gates import (
    control_damping_copy_mpo,
    control_damping_mpo,
)
from qilaplace_tpu_torch.core.mpo import PairedSiteMPO, identity_mpo, mpo_repad
from qilaplace_tpu_torch.ops.apply import (
    compose_layers,
    embed_window,
    stack_layers,
)
from qilaplace_tpu_torch.utils.config import bucket_for, resolve_device

# zips at cutoffs >= this run in the cap-bound range mode, tighter ones
# through the truncated SVD
RANGE_ZIP_CUTOFF = 1e-10


def zip_mode_for(cutoff: float) -> str:
    """The zip mode of the gate folds at ``cutoff``."""
    return "range" if cutoff >= RANGE_ZIP_CUTOFF else "svd"


def dt_layers(n: int, wr, dtype, device):
    """The DT gate layers embedded into the 2n chain: (Part 1, Part 2)."""
    p1 = [embed_window(control_damping_mpo(n, k, wr, dtype=dtype,
                                           device=device), 2 * n, 0)
          for k in range(1, n + 1)]
    p2 = [embed_window(control_damping_copy_mpo(n, k, wr, dtype=dtype,
                                                device=device),
                       2 * n, 2 * (k - 1))
          for k in range(1, n)]
    return p1, p2


def build_dt_mpo(n: int, wr: float, *, cutoff: float = 1e-14,
                 maxdim: int = 1000, chi: int | None = None,
                 dtype=torch.complex128, chi_work: int | None = None,
                 device=None) -> PairedSiteMPO:
    """Build the paired-register damping-transform MPO for damping ``wr``
    on ``device`` (the card unless told otherwise).

    ``chi_work`` (default 2 chi) is the fold's working bucket: the default
    keeps the zip-up exact so tight cutoffs reach canonical minimal ranks;
    ``chi_work=chi`` gives cheaper builds at loose cutoffs (>= ~1e-9).
    """
    if n < 1:
        raise ValueError(f"build_dt_mpo: n must be >= 1, got {n}")
    device = resolve_device(device)
    if chi is None:
        chi = bucket_for(min(maxdim, 32))  # plateau ~17-18
    # no bond of a 2n-site operator chain can exceed 4^n
    chi = min(chi, bucket_for(4**n))
    maxdim = min(maxdim, chi)

    if n == 1:
        return mpo_repad(control_damping_mpo(n, 1, wr, dtype=dtype,
                                             device=device), chi)
    p1, p2 = dt_layers(n, wr, dtype, device)
    # Sequential prefix fold, not a balanced tree: only prefix products of
    # these gate layers stay at the bond plateau. Mid-segment products have
    # large canonical rank, so a pair tree truncates real weight at any
    # feasible bucket, and pairing adjacent layers squares the layer rank
    # the zip capacity must cover (rank_acc * rank_layer).
    layer_cores, layer_ranks = stack_layers(p1 + p2)
    acc = identity_mpo(n, chi=chi, dtype=dtype, paired=True, device=device)
    out = compose_layers(acc.chain, layer_cores, layer_ranks, cutoff=cutoff,
                         maxdim=maxdim, chi_work=chi_work, polish="reverse",
                         zip_mode=zip_mode_for(cutoff))
    return PairedSiteMPO(chain=out)
