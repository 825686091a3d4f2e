"""Parameter carry-over from the JAX package's containers.

The JAX containers hold ``cores``, ``ranks`` and (for states)
``amplitude``; given those as numpy arrays (``np.asarray`` of each field),
these functions return the port's containers on ``device`` (the card
unless told otherwise), optionally
cast, so that both packages compute on identical states and operators.
"""

from __future__ import annotations

import numpy as np
import torch

from qilaplace_tpu_torch.core.mpo import MPO, PairedSiteMPO
from qilaplace_tpu_torch.core.mps import MPS, ZTMPS
from qilaplace_tpu_torch.utils.config import resolve_device


def mps_from_numpy(cores, ranks, amplitude, *, device=None,
                   dtype: torch.dtype | None = None, paired: bool = False):
    """MPS (or ZTMPS when ``paired``) from numpy ``cores [n, chi, 2, chi]``,
    ``ranks [n+1]`` and a scalar ``amplitude``."""
    device = resolve_device(device)
    chain = MPS(
        cores=torch.from_numpy(np.array(cores)).to(device=device, dtype=dtype),
        ranks=torch.from_numpy(np.array(ranks, np.int32)).to(device),
        amplitude=torch.as_tensor(np.array(amplitude), device=device),
    )
    return ZTMPS(chain=chain) if paired else chain


def mpo_from_numpy(cores, ranks, *, device=None,
                   dtype: torch.dtype | None = None, paired: bool = True):
    """PairedSiteMPO (or MPO when not ``paired``) from numpy
    ``cores [n, chi, 2, 2, chi]`` and ``ranks [n+1]``."""
    device = resolve_device(device)
    chain = MPO(
        cores=torch.from_numpy(np.array(cores)).to(device=device, dtype=dtype),
        ranks=torch.from_numpy(np.array(ranks, np.int32)).to(device),
    )
    return PairedSiteMPO(chain=chain) if paired else chain
