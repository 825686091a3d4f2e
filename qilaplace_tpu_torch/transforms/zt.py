"""zT MPO entry point.

Counterpart of ``qilaplace_tpu/transforms/zt.py`` (``zt_mpo`` only). The
analytic engine is ported; the gate-layer fold (``engine="gate"``) is
not yet.
"""

from __future__ import annotations

import torch

from qilaplace_tpu_torch.core.mpo import PairedSiteMPO
from qilaplace_tpu_torch.utils.config import resolve_device


def zt_mpo(
    n: int,
    wr: float,
    *,
    engine: str = "analytic",
    cutoff: float = 1e-12,
    maxdim: int = 160,
    chi: int | None = None,
    dtype: torch.dtype = torch.complex64,
    cache: bool = True,
    cache_dir: str | None = None,
    device=None,
    chi_work: int | None = None,
) -> PairedSiteMPO:
    """Production zT MPO: engine dispatch plus artifact cache.

    ``engine="analytic"`` evaluates the closed-form kernel by rail
    cross-interpolation and exact Schmidt-product compression in host f64
    (transforms/analytic.py). ``cache=True`` persists the finished operator
    as an .npz artifact keyed on (engine, n, wr, cutoff, maxdim, chi,
    dtype), readable by the JAX package too. The operator lands on
    ``device`` (the card unless told otherwise).
    """
    device = resolve_device(device)
    if engine == "gate":
        raise NotImplementedError(
            "zt_mpo: engine 'gate' is not ported yet "
            "(ROADMAP queue 1, item 12: gates + gate builders)"
        )
    if engine != "analytic":
        raise ValueError(
            f"zt_mpo: unknown engine {engine!r}; use 'analytic' or 'gate'"
        )
    if cache:
        from qilaplace_tpu_torch.utils.io import cached_zt_mpo

        W, _ = cached_zt_mpo(
            n, wr, cutoff=cutoff, maxdim=maxdim, chi=chi, dtype=dtype,
            chi_work=chi_work, cache_dir=cache_dir, device=device,
        )
        return W
    from qilaplace_tpu_torch.transforms.analytic import analytic_zt_mpo

    return analytic_zt_mpo(n, wr, cutoff=cutoff, maxdim=maxdim, chi=chi,
                           dtype=dtype, device=device)
