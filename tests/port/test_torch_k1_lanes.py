"""Kernel K1's live-lane pre-pass and row grouping, replayed on the CPU.

On the card, ``readout_kernels.coefficient_batch_k1`` first permutes the
lanes of every bond so that the live ones come first
(``pack_live_lanes``, plain torch) and the kernel multiplies only those.
Within a block it places the rows of each site by their bit
(:func:`row_slots`), multiplies every R-row register tile by its rows'
branches (one, or two for the one mixed tile) and writes each row's new
vector to its slot at the next site. These tests
check the pre-pass against the padded chain and the JAX package
(complex128, 1e-12), its widths against the JAX ranks, and a numpy
emulation of the kernel's grouping and write-back against the plain
version.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from qilaplace_tpu.core.mpo import MPO as JMPO, PairedSiteMPO as JPaired
from qilaplace_tpu.core.mps import MPS as JMPS, ZTMPS as JZTMPS
from qilaplace_tpu.ops.apply import (
    apply_coefficient_batch as j_apply_cb,
    zipper_chain as j_zipper,
)

import qilaplace_tpu_torch as qt
from qilaplace_tpu_torch.ops import readout_kernels as rk
from qilaplace_tpu_torch.utils.interop import mpo_from_numpy, mps_from_numpy

from port_helpers import embed, ragged_chain, random_cores, rel_err

CUDA_CONSTS = {k: int(v) for k, v in re.findall(
    r"constexpr int (\w+) = (\d+);",
    (Path(rk.__file__).parents[1] / "csrc" / rk.SOURCE).read_text())}
TB = CUDA_CONSTS["TB"]  # configurations per block
R = CUDA_CONSTS["R"]    # rows of a register tile

# (seed, n, operator ranks, state ranks, state bucket): the PAIRS of
# test_torch_readout.py, and a state of rank 2 in a bucket of 4, whose
# live lanes in the folded chain are {4a, 4a + 1}, not a prefix
PAIRS = [(0, 2, [1, 2, 3, 3, 1], [1, 2, 2, 2, 1], None),
         (1, 3, [1, 3, 5, 6, 5, 3, 1], [1, 2, 3, 4, 3, 2, 1], None),
         (2, 3, [1, 3, 5, 7, 5, 3, 1], [1, 2, 2, 2, 2, 2, 1], 4)]


def folded(seed, n, w_ranks, p_ranks, p_chi):
    """JAX operator and state, the port's zipper chain, and configs."""
    rng = np.random.default_rng(seed)
    Wj = JPaired(chain=JMPO.from_core_list(
        random_cores(rng, w_ranks, phys=(2, 2))))
    pj = JZTMPS(chain=JMPS.from_core_list(random_cores(rng, p_ranks),
                                          amplitude=1.3, chi=p_chi))
    Wt = mpo_from_numpy(np.asarray(Wj.chain.cores), np.asarray(Wj.chain.ranks),
                        device="cpu")
    pt = mps_from_numpy(np.asarray(pj.chain.cores), np.asarray(pj.chain.ranks),
                        np.asarray(pj.chain.amplitude), paired=True,
                        device="cpu")
    cfg = rng.integers(0, 2, (41, 2 * n)).astype(np.int32)
    return Wj, pj, qt.zipper_chain(Wt, pt), cfg


def packed_chain(chain):
    packed, widths = rk.pack_live_lanes(chain.cores)
    return qt.MPS(cores=packed, ranks=widths, amplitude=chain.amplitude), widths


def test_constants_match_the_cuda_source():
    for name in ("MAX_CHI", "LANE_TILE"):
        assert CUDA_CONSTS[name] == getattr(rk, name), name
    assert TB == 32 and TB % R == 0  # one ballot word of rows a block


@pytest.mark.parametrize("seed,n,w_ranks,p_ranks,p_chi", PAIRS)
def test_packed_chain_reads_the_same(seed, n, w_ranks, p_ranks, p_chi):
    Wj, pj, K, cfg = folded(seed, n, w_ranks, p_ranks, p_chi)
    P, widths = packed_chain(K)
    assert P.chi % rk.LANE_TILE == 0 and P.chi >= K.chi
    cfg_t = torch.from_numpy(cfg)
    want = rk.coefficient_batch_k1_reference(K, cfg_t).numpy()
    got = rk.coefficient_batch_k1_reference(P, cfg_t).numpy()
    assert rel_err(got, want) < 1e-12
    assert rel_err(got, np.asarray(j_apply_cb(Wj, pj, cfg))) < 1e-12
    # every lane past a bond's width is dead: its rows and columns may be
    # dropped (zeroed here) without changing a value
    cut = P.cores.clone()
    for s in range(P.n):
        cut[s, widths[s]:] = 0
        cut[s, :, :, widths[s + 1]:] = 0
    C = qt.MPS(cores=cut, ranks=widths, amplitude=P.amplitude)
    assert rel_err(rk.coefficient_batch_k1_reference(C, cfg_t).numpy(),
                   want) < 1e-12


@pytest.mark.parametrize("seed,n,w_ranks,p_ranks,p_chi", PAIRS)
def test_widths_are_the_products_of_the_jax_ranks(seed, n, w_ranks, p_ranks,
                                                  p_chi):
    Wj, pj, K, _ = folded(seed, n, w_ranks, p_ranks, p_chi)
    _, widths = rk.pack_live_lanes(K.cores)
    assert np.array_equal(widths.numpy(), np.asarray(j_zipper(Wj, pj).ranks))
    if p_chi == 4:  # rank 2 in a bucket of 4: the live lanes interleave
        live = rk.live_lanes(K.cores)
        lanes = torch.nonzero(live[2]).flatten().tolist()
        assert lanes == [4 * a + b for a in range(w_ranks[2]) for b in (0, 1)]


def test_dead_lane_in_the_middle_of_a_bond():
    rng = np.random.default_rng(5)
    ranks = [1, 2, 5, 7, 6, 3, 1]
    chain = ragged_chain(rng, 6, 8, ranks, {3: 2, 4: 0},
                         dtype=torch.complex128)
    live = rk.live_lanes(chain.cores)
    assert torch.nonzero(live[3]).flatten().tolist() == [0, 1, 3, 4, 5, 6]
    assert torch.nonzero(live[4]).flatten().tolist() == [1, 2, 3, 4, 5]
    P, widths = packed_chain(chain)
    assert widths.tolist() == [1, 2, 5, 6, 5, 3, 1]
    cfg = torch.from_numpy(rng.integers(0, 2, (50, 6)).astype(np.int32))
    assert rel_err(rk.coefficient_batch_k1_reference(P, cfg).numpy(),
                   rk.coefficient_batch_k1_reference(chain, cfg).numpy()
                   ) < 1e-12


def test_packing_ignores_extra_dead_lanes():
    rng = np.random.default_rng(9)
    chain = ragged_chain(rng, 7, 12, [1, 3, 9, 12, 10, 4, 2, 1], {4: 5},
                         dtype=torch.complex128)
    big = embed(chain, 40, np.random.default_rng(3))
    P, w = rk.pack_live_lanes(chain.cores)
    Pb, wb = rk.pack_live_lanes(big.cores)
    assert torch.equal(w, wb)
    for s in range(chain.n):
        a, b = int(w[s]), int(w[s + 1])
        assert torch.equal(P[s, :a, :, :b], Pb[s, :a, :, :b])


def row_slots(bits):
    """The kernel's row grouping at one site, for one block's rows: each
    row's slot, the bit-0 rows in slots [0, g0) and the bit-1 rows in
    [g0, g0 + g1), each group in row order (``group_rows`` in the CUDA
    source). Of the R-slot register tiles, at most one then holds rows of
    both bits."""
    bits = np.asarray(bits) != 0
    g0 = int((~bits).sum())
    slots = np.empty(len(bits), dtype=np.int64)
    slots[~bits] = np.arange(g0)
    slots[bits] = g0 + np.arange(int(bits.sum()))
    return slots


def emulate_kernel(packed, widths, bits, amp):
    """numpy replay of the kernel on a packed chain: blocks of TB rows; at
    every site the rows placed by ``row_slots``, each R-slot tile with a
    row in it multiplied over k < w_s and 64-column chunks (rows below the
    mixed tile's split point by branch 0, the rest by branch 1), and each
    row's result written to its slot at the next site (the last site
    writes amp * v[0]). vT starts as NaN outside row 0, as the kernel's
    shared memory is uninitialised: a value read unwritten shows."""
    packed = np.asarray(packed)
    widths = [int(w) for w in widths]
    B, n = bits.shape
    out = np.full(B, np.nan, dtype=complex)
    for b0 in range(0, B, TB):
        rows = bits[b0:b0 + TB]
        vT = np.full((packed.shape[1], TB + 2), np.nan, dtype=complex)
        vT[0] = 1
        slots = row_slots(rows[:, 0])
        for s in range(n):
            g0 = int((rows[:, s] == 0).sum())
            row_of_slot = np.full(TB, -1)
            row_of_slot[slots] = np.arange(len(rows))
            nxt = row_slots(rows[:, s + 1]) if s + 1 < n else None
            ws = widths[s]
            wc = -(-widths[s + 1] // rk.LANE_TILE) * rk.LANE_TILE
            results = []
            for tile in range(TB // R):
                lo = R * tile
                if lo >= len(rows):
                    continue
                split = g0 - lo if lo < g0 < lo + R else 0
                br = 0 if lo < g0 else 1
                for r in range(R):
                    b = (0 if r < split else 1) if split else br
                    acc = vT[:ws, lo + r] @ packed[s, :ws, b, :wc]
                    row = row_of_slot[lo + r]
                    if row >= 0:
                        assert rows[row, s] == b  # the row's own branch
                        results.append((row, acc))
            for row, vec in results:
                if nxt is None:
                    out[b0 + row] = amp * vec[0]
                else:
                    vT[:wc, nxt[row]] = vec
            slots = nxt
    return out


@pytest.mark.parametrize("kind", ["random", "zeros", "ones", "ragged"])
def test_row_grouping_emulation_matches_plain(kind):
    rng = np.random.default_rng(11)
    chain = ragged_chain(rng, 6, 70, [1, 2, 9, 70, 66, 5, 1], {3: 40},
                         dtype=torch.complex128)
    B = 77 if kind == "ragged" else 64
    bits = {"zeros": np.zeros((B, 6)), "ones": np.ones((B, 6))}.get(
        kind, rng.integers(0, 2, (B, 6))).astype(np.int32)
    packed, widths = rk.pack_live_lanes(chain.cores)
    got = emulate_kernel(packed.numpy(), widths.numpy(), bits,
                         float(chain.amplitude))
    want = rk.coefficient_batch_k1_reference(
        chain, torch.from_numpy(bits)).numpy()
    assert np.isfinite(got).all()
    assert rel_err(got, want) < 1e-12


@pytest.mark.parametrize("g0", [0, 1, 3, 4, 17, 31, 32])
def test_row_slots_leave_at_most_one_mixed_tile(g0):
    bits = np.array([0] * g0 + [1] * (TB - g0))
    np.random.default_rng(g0).shuffle(bits)
    slots = row_slots(bits)
    assert sorted(slots.tolist()) == list(range(TB))
    tiles = [set(bits[(slots // R) == t].tolist())
             for t in range(TB // R)]
    mixed = [t for t, b in enumerate(tiles) if len(b) > 1]
    assert len(mixed) == (0 if g0 % R == 0 else 1)
    if mixed:  # rows below the split point take branch 0
        t = mixed[0]
        lo = R * t
        order = bits[np.argsort(slots)][lo:lo + R]
        assert order.tolist() == [0] * (g0 - lo) + [1] * (lo + R - g0)
