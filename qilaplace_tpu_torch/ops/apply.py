"""MPO application, composition and the direct readouts.

Counterpart of ``qilaplace_tpu/ops/apply.py``:

* ``apply(W, psi)``: exact contraction with fused bonds, no truncation
  (output bond = the product of the bonds);
* ``apply(W, psi, maxdim=..., cutoff=...)``: the fused zip-up: contract a
  site, truncate, carry the remainder, so the product bond chi_W chi_psi is
  never formed across the chain; then two-site polish sweeps;
* ``apply_mpo_mpo(W1, W2)``: composition, W1 acts first (``W1 * W2`` means
  W2 after W1), with an ``offset`` for a shorter window MPO;
* ``compose_layers``: the fold of a stack of layer MPOs that the gate
  builders run (``lax.scan`` there, a Python loop here);
* ``zipper_chain`` and ``apply_coefficient_batch``: the direct
  ``<config| W |psi>`` readouts of the pole scan.

Every truncation goes through ops/truncation.py, so on the card each of
its eigensolves is a launch of kernel K2.

``apply`` also takes a batch of states (every field with the batch axis
first, core/mps.py) under one shared operator, and
``apply_coefficient_batch`` a stack of operators (``parallel.stack_mpos``)
over one shared state, and ``compose_layers`` several layer stacks folded
side by side (the zT build's factor stacks): the batch is an axis of every
contraction and of every factorization, so a batch costs the launches of
one state or one stack.
"""

from __future__ import annotations

import torch

from qilaplace_tpu_torch.core.mpo import MPO, PairedSiteMPO, _mpo_chain
from qilaplace_tpu_torch.core.mps import (
    MPS,
    ZTMPS,
    _chain,
    _rewrap,
    _sweep_right,
    _two_site_sweep,
)
from qilaplace_tpu_torch.ops.complexlinalg import slot_einsum
from qilaplace_tpu_torch.ops.truncation import (
    _is_fast,
    range_split,
    sketch_matrix,
    svd_split,
)


def _unit_carry(chi_x: int, a: int, b: int, dtype, device) -> torch.Tensor:
    C = torch.zeros(chi_x, a, b, dtype=dtype, device=device)
    C[0, 0, 0] = 1
    return C


def _apply_exact(W: MPO, psi: MPS) -> MPS:
    """Per-site contract and bond fuse; output chi = chiW * chiS. A batch
    of states [..., n, ...] shares ``W``."""
    n = psi.n
    if W.n != n:
        raise ValueError(
            f"apply: MPO and MPS must have the same number of sites "
            f"(got {W.n} and {n})"
        )
    dtype = torch.promote_types(W.dtype, psi.dtype)
    out = torch.einsum("naoic,...nbid->...nabocd", W.cores.to(dtype),
                       psi.cores.to(dtype))
    chi_out = W.chi * psi.chi
    return MPS(cores=out.reshape(*out.shape[:-5], chi_out, 2, chi_out),
               ranks=W.ranks * psi.ranks, amplitude=psi.amplitude)


def _apply_fused(W: MPO, psi: MPS, *, maxdim: int, cutoff: float,
                 chi_out: int | None = None, final_sweeps: int = 1,
                 chi_work: int | None = None, zip_mode: str = "svd") -> MPS:
    """Zip-up apply: contract a site, truncate, carry the remainder.

    The carry ``C[x, a, b]`` joins the truncated left part (bond x, size
    chi_work) to the not yet contracted W bond (a) and psi bond (b).
    ``chi_work`` (default ``chi_out``) is the bucket of the zip and polish
    stages: the zip truncates against a non-orthonormal right environment,
    so working at 2 chi_out restores exact-apply accuracy for about twice
    the zip flops. The final forward polish sweep leaves ranks <= maxdim <=
    chi_out in the leading block, so the closing slice is exact. A batch
    of states [..., n, ...] shares ``W``: the carry and every split carry
    the batch axes.
    """
    n, chiW, chiS = psi.n, W.chi, psi.chi
    lead = psi.cores.shape[:-4]
    if W.n != n:
        raise ValueError("apply: MPO and MPS must have the same number of sites")
    if chi_out is None:
        chi_out = min(maxdim, chiW * chiS)
    if chi_work is None:
        chi_work = chi_out
    chi_work = min(max(chi_work, chi_out), chiW * chiS)
    maxdim = min(maxdim, chi_out)
    dtype = torch.promote_types(W.dtype, psi.dtype)
    device = psi.device
    Wc, Ac = W.cores.to(dtype), psi.cores.to(dtype)

    # the zip inherits the polish cutoff's factorization profile
    fast = _is_fast(cutoff)
    C = _unit_carry(chi_work, chiW, chiS, dtype, device)
    if zip_mode == "range":
        # cap-bound zip: one shared Gaussian sketch, one eigensolve a site
        om = sketch_matrix(1234, chiW * chiS, chi_work, dtype, device=device)
    cores, bond_ranks = [], []
    for i in range(n - 1):
        T = slot_einsum("...xab,aoic,...bid->...xocd", C, Wc[i],
                        Ac.select(-4, i), core=(3, 4, 3))
        M = T.reshape(*lead, chi_work * 2, chiW * chiS)
        if zip_mode == "range":
            L, R, rank = range_split(M, om)
            rank = torch.clamp(rank, max=maxdim)
        else:
            L, R, rank = svd_split(M, cutoff=cutoff, maxdim=chi_work,
                                   absorb="right", out_dim=chi_work,
                                   fast=fast or None)
        cores.append(L.reshape(*lead, chi_work, 2, chi_work))
        bond_ranks.append(rank)
        C = R.reshape(*lead, chi_work, chiW, chiS)
    # last site: contract the remainder; the right boundary is index 0
    last = slot_einsum("...xab,aoic,...bid->...xocd", C, Wc[n - 1],
                       Ac.select(-4, n - 1), core=(3, 4, 3))[..., 0, 0]
    last_core = last.new_zeros(*lead, chi_work, 2, chi_work)
    last_core[..., 0] = last
    cores.append(last_core)
    cores = torch.stack(cores, dim=-4)
    ranks = torch.ones(*lead, n + 1, dtype=torch.int32, device=device)
    if n > 1:
        ranks[..., 1:n] = torch.stack(bond_ranks, dim=-1)

    # a wider zip must be swept down before the closing slice
    sweeps = final_sweeps if chi_work == chi_out else max(final_sweeps, 1)
    for _ in range(sweeps):
        cores, ranks = _two_site_sweep(cores, ranks, cutoff=cutoff,
                                       maxdim=maxdim, reverse=True)
        cores, ranks = _two_site_sweep(cores, ranks, cutoff=cutoff,
                                       maxdim=maxdim, reverse=False)
    if chi_work > chi_out:
        cores = cores[..., :chi_out, :, :chi_out].contiguous()
    return MPS(cores=cores, ranks=ranks, amplitude=psi.amplitude)


def apply(W, psi, *, maxdim: int | None = None, cutoff: float | None = None,
          chi_out: int | None = None, final_sweeps: int = 1,
          chi_work: int | None = None, zip_mode: str = "svd"):
    """Apply an MPO to an MPS (or a PairedSiteMPO to a ZTMPS).

    Without ``maxdim``/``cutoff``/``chi_out``: exact, untruncated. With
    them: the fused zip-up and polish. ``zip_mode='range'`` replaces the
    per-site truncated SVD with the cap-only randomized range split.
    """
    Wm = _mpo_chain(W)
    pm = _chain(psi)
    if isinstance(psi, ZTMPS) != isinstance(W, PairedSiteMPO):
        raise TypeError(
            "apply: pair SingleSiteMPO with SignalMPS and PairedSiteMPO with ZTMPS"
        )
    if maxdim is None and cutoff is None and chi_out is None:
        res = _apply_exact(Wm, pm)
    else:
        res = _apply_fused(
            Wm, pm,
            maxdim=maxdim if maxdim is not None else (chi_out or Wm.chi * pm.chi),
            cutoff=0.0 if cutoff is None else cutoff,
            chi_out=chi_out, final_sweeps=final_sweeps, chi_work=chi_work,
            zip_mode=zip_mode,
        )
    return _rewrap(psi, res)


def _compose_fused(A: MPO, B: MPO, *, chi_out: int, zip_maxdim: int,
                   cutoff: float, maxdim: int, final_sweeps: int = 1,
                   chi_work: int | None = None, polish: str = "full",
                   zip_mode: str = "svd") -> MPO:
    """Zip-up composition B after A with mask truncation.

    Stage 1 (zip-up, cutoff 0): contract site by site keeping at most
    ``zip_maxdim`` singular values; exact whenever the true intermediate
    rank fits, and it leaves the chain left-canonical. Stage 2: two-site
    polish sweeps (right to left, then left to right unless
    ``polish='reverse'``) with the real ``cutoff``/``maxdim``. ``chi_work``
    (default 2 chi_out, capped by the product bond) is the bucket of both
    stages; the final truncating sweep leaves ranks <= maxdim <= chi_out in
    the leading block, so the closing slice is exact.

    A and B may carry the same leading batch axes (cores [..., n, chi, 2,
    2, chi], ranks [..., n+1]), as ``jax.vmap`` of the JAX package's
    composition gives them: each slot has its own carry and ranks, every
    split takes the whole batch, and the range-mode sketch is one matrix
    shared by every slot.
    """
    n, chiA, chiB = A.n, A.chi, B.chi
    lead = torch.broadcast_shapes(A.cores.shape[:-5], B.cores.shape[:-5])
    dtype = torch.promote_types(A.dtype, B.dtype)
    device = A.device
    if chi_work is None:
        chi_work = min(2 * chi_out, chiA * chiB)
    chi_work = max(chi_work, chi_out)
    zip_maxdim = min(zip_maxdim, chi_work)
    maxdim = min(maxdim, chi_out)
    Bc, Ac = B.cores.to(dtype), A.cores.to(dtype)

    # the zip runs at cutoff 0 but inherits the polish's profile
    fast = _is_fast(cutoff)
    C = _unit_carry(chi_work, chiB, chiA, dtype, device).expand(
        *lead, chi_work, chiB, chiA)
    if zip_mode == "range":
        om = sketch_matrix(1234, chiB * chiA, chi_work, dtype, device=device)
    cores4, bond_ranks = [], []
    for i in range(n - 1):
        T = slot_einsum("...xba,...botc,...atid->...xoicd", C,
                        Bc.select(-5, i), Ac.select(-5, i), core=(3, 4, 4))
        M = T.reshape(*lead, chi_work * 4, chiB * chiA)
        if zip_mode == "range":
            L, R, rank = range_split(M, om)
            rank = torch.clamp(rank, max=zip_maxdim)
        else:
            L, R, rank = svd_split(M, cutoff=0.0, maxdim=zip_maxdim,
                                   absorb="right", out_dim=chi_work,
                                   fast=fast or None)
        cores4.append(L.reshape(*lead, chi_work, 4, chi_work))
        bond_ranks.append(rank)
        C = R.reshape(*lead, chi_work, chiB, chiA)
    last = slot_einsum("...xba,...botc,...atid->...xoicd", C,
                       Bc.select(-5, n - 1), Ac.select(-5, n - 1),
                       core=(3, 4, 4))
    last_core = last.new_zeros(*lead, chi_work, 4, chi_work)
    last_core[..., 0] = last[..., 0, 0].reshape(*lead, chi_work, 4)
    cores4.append(last_core)
    cores4 = torch.stack(cores4, dim=-4)
    ranks = torch.ones(*lead, n + 1, dtype=torch.int32, device=device)
    if n > 1:
        ranks[..., 1:n] = torch.stack(bond_ranks, dim=-1)

    for _ in range(final_sweeps):
        cores4, ranks = _two_site_sweep(cores4, ranks, cutoff=cutoff,
                                        maxdim=maxdim, reverse=True)
        if polish == "full":
            cores4, ranks = _two_site_sweep(cores4, ranks, cutoff=cutoff,
                                            maxdim=maxdim, reverse=False)
    if chi_work > chi_out:
        cores4 = cores4[..., :chi_out, :, :chi_out]
    return MPO(cores=cores4.reshape(*lead, n, chi_out, 2, 2, chi_out)
               .contiguous(), ranks=ranks)


def compose_layers(acc: MPO, layer_cores: torch.Tensor,
                   layer_ranks: torch.Tensor, *, cutoff: float, maxdim: int,
                   final_sweeps: int = 1, chi_work: int | None = None,
                   polish: str = "full", zip_mode: str = "svd") -> MPO:
    """Fold a stack of layer MPOs into ``acc``: result = layer_L after ...
    after layer_1 after acc, each step the fused zip-up composition and
    polish at acc's bucket.

    layer_cores: [..., L, n, cl, 2, 2, cl]; layer_ranks: [..., L, n+1].
    Leading axes fold that many stacks at once, each into its own slot of
    ``acc`` (which carries the same axes): every eigensolve of the fold is
    one call for all of them, as the JAX package's ``jax.vmap`` of its
    fold is one ``pallas_call`` for all.
    """
    chi = acc.chi
    chi_layer = layer_cores.shape[-1]
    if chi_work is None:
        chi_work = min(2 * chi, chi * chi_layer)
    cores, ranks = acc.cores, acc.ranks
    for l in range(layer_cores.shape[-6]):
        out = _compose_fused(
            MPO(cores=cores, ranks=ranks),
            MPO(cores=layer_cores.select(-6, l),
                ranks=layer_ranks.select(-2, l)),
            chi_out=chi, zip_maxdim=chi_work, cutoff=cutoff, maxdim=maxdim,
            final_sweeps=final_sweeps, chi_work=chi_work, polish=polish,
            zip_mode=zip_mode,
        )
        cores, ranks = out.cores, out.ranks
    return MPO(cores=cores, ranks=ranks)


def stack_layers(layers) -> tuple[torch.Tensor, torch.Tensor]:
    """Stack equal-shape MPO chains into (cores [L, ...], ranks [L, n+1])
    for :func:`compose_layers`."""
    chains = [_mpo_chain(l) for l in layers]
    return (torch.stack([c.cores for c in chains]),
            torch.stack([c.ranks for c in chains]))


def pair_layer_stack(layers) -> tuple[torch.Tensor, torch.Tensor]:
    """Exactly compose adjacent layer pairs and stack the results: pair i
    = layer_{2i+1} after layer_{2i}, so folding the pair stack equals
    folding the list with half the fold steps. An odd tail layer is paired
    with the identity. Returns ``(cores [ceil(L/2), n, cl^2, 2, 2, cl^2],
    ranks [ceil(L/2), n+1])``."""
    chains = [_mpo_chain(l) for l in layers]
    if len(chains) % 2:
        n, chi_l = chains[0].n, chains[0].chi
        eye = torch.zeros(n, chi_l, 2, 2, chi_l, dtype=chains[0].dtype,
                          device=chains[0].device)
        eye[:, 0, 0, 0, 0] = 1
        eye[:, 0, 1, 1, 0] = 1
        chains.append(MPO(cores=eye, ranks=torch.ones(
            n + 1, dtype=torch.int32, device=eye.device)))
    Ac = torch.stack([c.cores for c in chains[0::2]])  # acts first
    Bc = torch.stack([c.cores for c in chains[1::2]])
    P, n, chi_l = Ac.shape[0], Ac.shape[1], Ac.shape[2]
    out = torch.einsum("pnbotc,pnatid->pnbaoicd", Bc, Ac)
    out = out.reshape(P, n, chi_l * chi_l, 2, 2, chi_l * chi_l)
    ranksA = torch.stack([c.ranks for c in chains[0::2]])
    ranksB = torch.stack([c.ranks for c in chains[1::2]])
    return out, ranksA * ranksB


def apply_mpo_mpo(W1, W2, *, maxdim: int | None = None,
                  cutoff: float | None = None, chi_out: int | None = None,
                  zip_maxdim: int | None = None, final_sweeps: int = 1,
                  chi_work: int | None = None, offset: int | None = None,
                  polish: str = "full", zip_mode: str = "svd"):
    """Compose two MPOs: result = W2 after W1 (W1 acts first), so
    mpo_to_dense(result) == mpo_to_dense(W2) @ mpo_to_dense(W1).

    When the lengths differ, the shorter MPO acts on a window of the longer
    chain, identity outside: ``offset`` is the 0-based site of its first
    site (in register sites for paired MPOs). Without truncation kwargs the
    composition is exact with product bonds; with them it runs the fused
    zip-up and polish.
    """
    paired = isinstance(W1, PairedSiteMPO)
    if paired != isinstance(W2, PairedSiteMPO):
        raise TypeError(
            "apply_mpo_mpo: both operands must have the same register type")
    A, B = _mpo_chain(W1), _mpo_chain(W2)
    if A.n != B.n:
        if offset is None:
            raise ValueError(
                "apply_mpo_mpo: lengths differ; pass offset=<site position "
                "of the shorter MPO's window within the longer chain> "
                f"(got {A.n} and {B.n} chain sites)"
            )
        step = 2 if paired else 1
        n_long = max(A.n, B.n)
        if A.n < B.n:
            A = _mpo_chain(embed_window(W1, n_long, step * offset))
        else:
            B = _mpo_chain(embed_window(W2, n_long, step * offset))
    elif offset not in (None, 0):
        raise ValueError(
            "apply_mpo_mpo: offset is only meaningful for unequal lengths")
    if maxdim is None and cutoff is None and chi_out is None:
        dtype = torch.promote_types(A.dtype, B.dtype)
        out = torch.einsum("nbotc,natid->nbaoicd", B.cores.to(dtype),
                           A.cores.to(dtype))
        chi_prod = A.chi * B.chi
        res = MPO(cores=out.reshape(A.n, chi_prod, 2, 2, chi_prod),
                  ranks=A.ranks * B.ranks)
    else:
        if chi_out is None:
            chi_out = min(maxdim or A.chi * B.chi, A.chi * B.chi)
        if chi_work is None:
            chi_work = min(2 * chi_out, A.chi * B.chi)
        res = _compose_fused(
            A, B, chi_out=chi_out,
            zip_maxdim=zip_maxdim if zip_maxdim is not None else chi_work,
            cutoff=0.0 if cutoff is None else cutoff,
            maxdim=maxdim if maxdim is not None else chi_out,
            final_sweeps=final_sweeps, chi_work=chi_work, polish=polish,
            zip_mode=zip_mode,
        )
    return PairedSiteMPO(chain=res) if paired else res


def mpo_compress(W, *, cutoff: float = 1e-14, maxdim: int | None = None,
                 sweeps: int = 1):
    """Two-pass canonical compression of an MPO chain: a gauge sweep, then
    truncating two-site sweeps."""
    m = _mpo_chain(W)
    n, chi = m.n, m.chi
    if maxdim is None:
        maxdim = chi
    cores4 = m.cores.reshape(n, chi, 4, chi)
    cores4, ranks = _sweep_right(cores4, m.ranks, cutoff=0.0, maxdim=chi,
                                 start=0, stop=n - 1)
    for _ in range(sweeps):
        cores4, ranks = _two_site_sweep(cores4, ranks, cutoff=cutoff,
                                        maxdim=maxdim, reverse=True)
        cores4, ranks = _two_site_sweep(cores4, ranks, cutoff=cutoff,
                                        maxdim=maxdim, reverse=False)
    res = MPO(cores=cores4.reshape(n, chi, 2, 2, chi), ranks=ranks)
    return PairedSiteMPO(chain=res) if isinstance(W, PairedSiteMPO) else res


def embed_window(W, n_total: int, start: int):
    """Embed a window MPO into an ``n_total``-site chain, identities
    outside."""
    m = _mpo_chain(W)
    nw, chi = m.n, m.chi
    if start < 0 or start + nw > n_total:
        raise ValueError("embed_window: window out of range")
    eye = torch.zeros(chi, 2, 2, chi, dtype=m.dtype, device=m.device)
    eye[0, 0, 0, 0] = 1
    eye[0, 1, 1, 0] = 1
    cores = torch.cat([eye.expand(start, chi, 2, 2, chi), m.cores,
                       eye.expand(n_total - start - nw, chi, 2, 2, chi)])
    ones = lambda k: torch.ones(k, dtype=torch.int32, device=m.device)  # noqa: E731
    ranks = torch.cat([ones(start), m.ranks, ones(n_total - start - nw)])
    out = MPO(cores=cores, ranks=ranks)
    return PairedSiteMPO(chain=out) if isinstance(W, PairedSiteMPO) else out


def apply_coefficient_batch(W, psi, configs) -> torch.Tensor:
    """Batched ``<config| W |psi>`` without forming the truncated product.

    ``configs`` is [B, n] output bits (site 1 = MSB). Per site: one
    contraction of the running [B, chi_W, chi_psi] environment with the
    whole W core, a per-config output-bit select, then one contraction with
    the psi core over (psi bond, s). Roundoff stays relative to the running
    path product, which is what keeps f32 scans accurate near a pole.

    A stack of operators [S, ...] (``parallel.stack_mpos``) gives [S, B]:
    the stack is the leading axis of the environment and of each
    contraction, as ``jax.vmap`` over the operator does.
    """
    wm = _mpo_chain(W)
    pm = _chain(psi)
    dtype = torch.promote_types(wm.dtype, pm.dtype)
    configs = torch.as_tensor(configs, device=pm.device)
    B = configs.shape[0]
    cw, cp = wm.chi, pm.chi
    lead = wm.cores.shape[:-5]
    v = torch.zeros(*lead, B, cw, cp, dtype=dtype, device=pm.device)
    v[..., 0, 0] = 1
    for site in range(pm.n):
        Wc = wm.cores.select(-5, site).to(dtype)  # [..., cw, 2, 2, cw]
        pc = pm.cores[site].to(dtype)  # [cp, 2, cp]
        t = torch.einsum("...Bab,...aK->...BbK", v,
                         Wc.reshape(*lead, cw, 4 * cw))
        t = t.reshape(*lead, B, cp, 2, 2, cw)
        sel = (configs[:, site] == 0)[:, None, None, None]
        # [..., B, cp, 2(s), cw]
        t = torch.where(sel, t.select(-3, 0), t.select(-3, 1))
        v = torch.einsum("...BbsA,bsc->...BAc", t, pc)
    return pm.amplitude * v[..., 0, 0]


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


# Operator sugar: W * psi and W1 * W2, where W1 * W2 means W2 after W1
# (W1's output feeds W2's input), as in the JAX package.
def _mpo_mul(self, other):
    if isinstance(other, (MPS, ZTMPS)):
        return apply(self, other)
    if isinstance(other, (MPO, PairedSiteMPO)):
        return apply_mpo_mpo(self, other)
    return NotImplemented


MPO.__mul__ = _mpo_mul
PairedSiteMPO.__mul__ = _mpo_mul
