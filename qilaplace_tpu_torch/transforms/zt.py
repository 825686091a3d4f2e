"""z-transform (discrete Laplace) MPO builders and the zT entry point.

Counterpart of ``qilaplace_tpu/transforms/zt.py``: W_zt = W_qft_paired
after W_dt. The DT factor and the paired 2n-site QFT are each folded from
their gate layers at a small bond budget, then fused once, DT acting
first, by a zip-up composition and a polish at the full chi. On the card
every truncation's eigensolves are K2 launches.

Coefficients: chi(k, l) = (1/N) sum_j x_j e^{-(wr k + 2 pi i l) j / N},
addressed on the output by interleaved LSB-first (k, l) bits. The bond
plateaus near 89-92.

The factor stacks are folded side by side as one batched program, as the
JAX package's ``jax.vmap`` folds them: each eigensolve of the fold is one
call (one K2 launch on the card) with every stack in its batch.
"""

from __future__ import annotations

import torch

from qilaplace_tpu_torch.circuits.dt_gates import control_damping_mpo
from qilaplace_tpu_torch.circuits.zt_gates import control_Hphase_ztmps_mpo
from qilaplace_tpu_torch.core.mpo import (
    MPO,
    PairedSiteMPO,
    identity_mpo,
    mpo_repad,
)
from qilaplace_tpu_torch.ops.apply import (
    apply_mpo_mpo,
    compose_layers,
    embed_window,
    stack_layers,
)
from qilaplace_tpu_torch.transforms.dt import (
    RANGE_ZIP_CUTOFF,
    build_dt_mpo,
    dt_layers,
    zip_mode_for,
)
from qilaplace_tpu_torch.utils.config import bucket_for, resolve_device


def _qft_layers(n: int, dtype, device):
    return [embed_window(control_Hphase_ztmps_mpo(k, dtype=dtype,
                                                  device=device), 2 * n, 0)
            for k in range(1, n + 1)]


def build_paired_qft_mpo(n: int, *, cutoff: float = 1e-14,
                         maxdim: int = 1000, chi: int | None = None,
                         dtype=torch.complex128, chi_work: int | None = None,
                         device=None) -> PairedSiteMPO:
    """The paired 2n-site QFT factor of the z-transform (it acts on the
    copy register), on ``device`` (the card unless told otherwise)."""
    device = resolve_device(device)
    if chi is None:
        chi = bucket_for(min(maxdim, 16))
    chi = min(chi, bucket_for(4**n))
    maxdim = min(maxdim, chi)
    if n == 1:
        return mpo_repad(control_Hphase_ztmps_mpo(1, dtype=dtype,
                                                  device=device), chi)
    # sequential prefix fold: see the capacity note in transforms/dt.py
    layer_cores, layer_ranks = stack_layers(_qft_layers(n, dtype, device))
    acc = identity_mpo(n, chi=chi, dtype=dtype, paired=True, device=device)
    out = compose_layers(acc.chain, layer_cores, layer_ranks, cutoff=cutoff,
                         maxdim=maxdim, chi_work=chi_work, polish="reverse",
                         zip_mode=zip_mode_for(cutoff))
    return PairedSiteMPO(chain=out)


def _pad_stack(layers, chi_l: int, L: int):
    """Stack ``layers`` at bucket ``chi_l`` and pad the stack to ``L``
    layers with identity layers, as the JAX package pads its vmapped
    stacks (the identity layers are folded too)."""
    cores, ranks = stack_layers([mpo_repad(l, chi_l) for l in layers])
    pad = L - cores.shape[0]
    if pad == 0:
        return cores, ranks
    n2 = cores.shape[1]
    eye = cores.new_zeros(pad, n2, chi_l, 2, 2, chi_l)
    eye[:, :, 0, 0, 0, 0] = 1
    eye[:, :, 0, 1, 1, 0] = 1
    return (torch.cat([cores, eye]),
            torch.cat([ranks, ranks.new_ones(pad, n2 + 1)]))


def _factor_stacks(n: int, wr: float, *, cutoff: float, maxdim: int,
                   chi_f: int, dtype, chi_work_f: int | None, device):
    """What ``_build_factors_concurrent`` folds: ``(acc, lay_c, lay_r,
    fold_kw)``, with ``compose_layers(acc, lay_c, lay_r, **fold_kw)`` the
    fold.

    The stacks (Part 1, Part 2 and the paired QFT at loose cutoffs; the
    whole DT stack and the paired QFT below) are padded to one bucket and
    length and stacked: lay_c [S, L, 2n, cl, 2, 2, cl], lay_r
    [S, L, 2n+1]; ``acc`` is the identity at the factor bucket, one slot
    a stack."""
    if cutoff >= RANGE_ZIP_CUTOFF:
        stacks = [*dt_layers(n, wr, dtype, device),
                  _qft_layers(n, dtype, device)]
    else:
        p1_layers, p2_layers = dt_layers(n, wr, dtype, device)
        stacks = [p1_layers + p2_layers, _qft_layers(n, dtype, device)]
    chi_l = max(l.chain.chi for st in stacks for l in st)
    L = max(len(st) for st in stacks)
    padded = [_pad_stack(st, chi_l, L) for st in stacks]
    lay_c = torch.stack([c for c, _ in padded])
    lay_r = torch.stack([r for _, r in padded])
    eye = identity_mpo(n, chi=chi_f, dtype=dtype, paired=True,
                       device=device).chain
    S = len(stacks)
    acc = MPO(cores=eye.cores.expand(S, *eye.cores.shape),
              ranks=eye.ranks.expand(S, *eye.ranks.shape))
    fold_kw = dict(cutoff=cutoff, maxdim=min(maxdim, chi_f),
                   chi_work=chi_work_f, polish="reverse",
                   zip_mode=zip_mode_for(cutoff))
    return acc, lay_c, lay_r, fold_kw


def _build_factors_concurrent(n: int, wr: float, *, cutoff: float,
                              maxdim: int, chi_f: int, dtype,
                              chi_work_f: int | None, device):
    """Build the DT and paired-QFT zT factors as one batched layer fold,
    returning ``(W_dt, W_qft)``.

    The fold's latency is its sequential layer count. At loose cutoffs
    (>= 1e-10) the DT stack is split at its seam into Part 1 (n layers)
    and Part 2 (n-1 layers), both prefix folds in their own right, folded
    beside the n-layer QFT stack (three stacks of length n instead of two
    of length 2n-1); DT = Part 2 after Part 1 is then restored by one
    fused composition at the factor bucket. At tight cutoffs the split is
    not used: that extra composition and the standalone Part 2 product are
    not plateau-bounded prefix products, so their capacity-bound zips lose
    real mass. There the DT stack folds as one chain beside the padded QFT
    stack. The split changes the numbers against one sequential 2n-1
    fold, so it is kept exactly.
    """
    acc, lay_c, lay_r, fold_kw = _factor_stacks(
        n, wr, cutoff=cutoff, maxdim=maxdim, chi_f=chi_f, dtype=dtype,
        chi_work_f=chi_work_f, device=device)
    out = compose_layers(acc, lay_c, lay_r, **fold_kw)
    folded = [PairedSiteMPO(chain=MPO(cores=out.cores[s], ranks=out.ranks[s]))
              for s in range(lay_c.shape[0])]
    if len(folded) == 2:
        return folded[0], folded[1]
    W_p1, W_p2, W_qft = folded
    W_dt = apply_mpo_mpo(W_p1, W_p2, chi_out=chi_f, cutoff=cutoff,
                         maxdim=fold_kw["maxdim"],
                         chi_work=min(2 * chi_f, chi_f * chi_f),
                         polish="reverse", zip_mode=fold_kw["zip_mode"])
    return W_dt, W_qft


def build_zt_mpo(n: int, wr: float, *, cutoff: float = 1e-14,
                 maxdim: int = 1000, chi: int | None = None,
                 chi_dt: int | None = None, chi_qft: int | None = None,
                 dtype=torch.complex128, chi_work: int | None = None,
                 device=None) -> PairedSiteMPO:
    """Build the z-transform MPO at damping ``wr`` (the angular axis fixed
    at omega_i = 2 pi by the QFT factor) on ``device`` (the card unless
    told otherwise).

    The DT factor is folded at its own small bond budget (plateau ~18),
    the paired QFT at its budget, then they are fused once with a zip-up
    composition at the full ``chi`` and a polish. The small-budget stages
    keep the O(n^2) sweep factorizations small; only the fuse works at chi.
    """
    if n < 1:
        raise ValueError(f"build_zt_mpo: n must be >= 1, got {n}")
    device = resolve_device(device)
    if chi is None:
        chi = bucket_for(min(maxdim, 128))  # plateau ~89-92
    chi = min(chi, bucket_for(4**n))
    maxdim_out = min(maxdim, chi)
    if chi_dt is None:
        chi_dt = min(bucket_for(min(maxdim, 32)), bucket_for(4**n))
    if chi_qft is None:
        chi_qft = min(bucket_for(min(maxdim, 32)), bucket_for(4**n))

    if n == 1:
        W_dt = mpo_repad(control_damping_mpo(n, 1, wr, dtype=dtype,
                                             device=device), 8)
        W_qft = control_Hphase_ztmps_mpo(1, dtype=dtype, device=device)
        return mpo_repad(apply_mpo_mpo(W_dt, W_qft), chi)

    if chi_dt == chi_qft:
        W_dt, W_qft = _build_factors_concurrent(
            n, wr, cutoff=cutoff, maxdim=maxdim, chi_f=chi_dt, dtype=dtype,
            chi_work_f=None, device=device)
    else:
        W_dt = build_dt_mpo(n, wr, cutoff=cutoff, maxdim=maxdim, chi=chi_dt,
                            dtype=dtype, device=device)
        W_qft = build_paired_qft_mpo(n, cutoff=cutoff, maxdim=maxdim,
                                     chi=chi_qft, dtype=dtype, device=device)
    return _fuse_factors(W_dt, W_qft, chi=chi, cutoff=cutoff,
                         maxdim=maxdim_out, chi_work=chi_work)


def _fuse_factors(W_dt, W_qft, *, chi: int, cutoff: float, maxdim: int,
                  chi_work: int | None = None) -> PairedSiteMPO:
    """The fuse of :func:`build_zt_mpo`: W_qft after W_dt by a zip-up
    (range mode at loose cutoffs) and one canonical reverse truncating
    sweep, which sets the final ~89-92 plateau.

    The factor folds work at capacity 2 chi_f: the zip bond must cover
    rank_acc * rank_layer (~18 * 3). The fuse capacity only has to cover
    the true product rank rank_dt * rank_qft ~= 18 * 8 = 144, so chi + 32
    (160 at chi 128) is exact at loose cutoffs while its zip eigensolves
    are smaller than at 2 chi; tight cutoffs keep 2 chi.
    """
    if chi_work is None:
        chi_work = (min(2 * chi, chi + 32) if cutoff >= RANGE_ZIP_CUTOFF
                    else 2 * chi)
    return apply_mpo_mpo(W_dt, W_qft, chi_out=chi, cutoff=cutoff,
                         maxdim=maxdim, chi_work=chi_work, polish="reverse",
                         zip_mode=zip_mode_for(cutoff))


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
    (transforms/analytic.py). ``engine="gate"`` folds the ~3n gate layers
    on the device (:func:`build_zt_mpo`). ``cache=True`` persists the
    finished operator as an .npz artifact keyed on (engine, n, wr, cutoff,
    maxdim, chi, dtype, chi_work), readable by the JAX package too. The
    operator lands on ``device`` (the card unless told otherwise).
    """
    device = resolve_device(device)
    if engine not in ("analytic", "gate"):
        raise ValueError(
            f"zt_mpo: unknown engine {engine!r}; use 'analytic' or 'gate'"
        )
    if cache:
        from qilaplace_tpu_torch.utils.io import cached_zt_mpo

        W, _ = cached_zt_mpo(
            n, wr, cutoff=cutoff, maxdim=maxdim, chi=chi, dtype=dtype,
            chi_work=chi_work, cache_dir=cache_dir, device=device,
            engine=engine,
        )
        return W
    if engine == "analytic":
        from qilaplace_tpu_torch.transforms.analytic import analytic_zt_mpo

        return analytic_zt_mpo(n, wr, cutoff=cutoff, maxdim=maxdim, chi=chi,
                               dtype=dtype, device=device)
    return build_zt_mpo(n, wr, cutoff=cutoff, maxdim=maxdim, chi=chi,
                        dtype=dtype, chi_work=chi_work, device=device)
