"""Direct ``<config| W |psi>`` readouts.

Counterpart of ``qilaplace_tpu/ops/apply.py`` for the two readout
functions of the pole-scan path: :func:`zipper_chain` and
:func:`apply_coefficient_batch`. In the JAX package both run outside any
Pallas kernel, so here they are plain torch einsums; the MPO-MPS apply and
compose family is not ported yet.
"""

from __future__ import annotations

import torch

from qilaplace_tpu_torch.core.mpo import _mpo_chain
from qilaplace_tpu_torch.core.mps import MPS, _chain


def apply_coefficient_batch(W, psi, configs) -> torch.Tensor:
    """Batched ``<config| W |psi>`` without forming the truncated product.

    ``configs`` is [B, n] output bits (site 1 = MSB). Per site: one
    contraction of the running [B, chi_W, chi_psi] environment with the
    whole W core, a per-config output-bit select, then one contraction with
    the psi core over (psi bond, s). Roundoff stays relative to the running
    path product, which is what keeps f32 scans accurate near a pole.
    """
    wm = _mpo_chain(W)
    pm = _chain(psi)
    dtype = torch.promote_types(wm.dtype, pm.dtype)
    configs = torch.as_tensor(configs, device=pm.device)
    B = configs.shape[0]
    cw, cp = wm.chi, pm.chi
    v = torch.zeros(B, cw, cp, dtype=dtype, device=pm.device)
    v[:, 0, 0] = 1
    for site in range(pm.n):
        Wc = wm.cores[site].to(dtype)  # [cw, 2, 2, cw]
        pc = pm.cores[site].to(dtype)  # [cp, 2, cp]
        t = torch.einsum("Bab,aK->BbK", v, Wc.reshape(cw, 4 * cw))
        t = t.reshape(B, cp, 2, 2, cw)
        sel = (configs[:, site] == 0)[:, None, None, None]
        t = torch.where(sel, t[:, :, 0], t[:, :, 1])  # [B, cp, 2(s), cw]
        v = torch.einsum("BbsA,bsc->BAc", t, pc)
    return pm.amplitude * v[:, 0, 0]


def zipper_chain(W, psi) -> MPS:
    """Per-site Kronecker combination of an operator and a state into one
    effective chain of branch-selected transfer matrices:

        K[site, (a,b), o, (c,d)] = sum_s W[a, o, s, c] * psi[b, s, d]

    Contracting K along a configuration of output bits reproduces
    ``<config| W |psi>`` exactly; the readout then becomes two
    chi_eff x chi_eff branch matmuls per site with chi_eff = chi_W * chi_psi
    (the shape the readout kernel takes)."""
    wm = _mpo_chain(W)
    pm = _chain(psi)
    if wm.n != pm.n:
        raise ValueError("zipper_chain: site-count mismatch")
    dtype = torch.promote_types(wm.dtype, pm.dtype)
    K = torch.einsum("naosc,nbsd->nabocd", wm.cores.to(dtype),
                     pm.cores.to(dtype))
    chi = wm.chi * pm.chi
    K = K.reshape(pm.n, chi, 2, chi).contiguous()
    return MPS(cores=K, ranks=wm.ranks * pm.ranks, amplitude=pm.amplitude)
