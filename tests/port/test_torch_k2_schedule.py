"""Kernel K2's schedule and index arithmetic, replayed on the CPU.

The kernel (csrc/jacobi_eigh.cu) reads one table from the wrapper,
``jacobi_kernels.position_moves(m)``: each round writes position p's
entries to position ``dst[p]`` of the next round's buffer. These tests
replay that table in numpy against the plain version's tournament
(``_tournament_sigma``), mirror the kernel's launch geometry (thread
tid = y * w + K takes the blocks (I, K) for I = y, y + Y, ...; whole warps
after those make the rotations; w = c column pairs in one block for
m <= 84 and m > 320, about PAIRS_PER_BLOCK a block of a cluster between),
and run numpy emulations of its rounds against the plain torch solver:
the one-block variant (columns stored even positions first, double
buffer, stores at the next positions, each round's rotations rebuilt from
the previous G and rotations), and the cluster variant in its own storage
(each block's columns of G, stores across a range's edge into the
neighbour's buffer, makers placed where they read across an edge only
what the holding block wrote, writing every block's table and the
rotation log, then V from the log alone, a row at a time).
The two emulations run the same arithmetic, so they agree bit for bit;
against the plain version (whose CPU matrix products round otherwise) they
are held to ``jacobi_kernels.tolerance``. On the card the kernel matches
the plain version bit for bit (tests/port/test_torch_k2_gpu.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from qilaplace_tpu_torch.ops import jacobi as tj
from qilaplace_tpu_torch.ops import jacobi_kernels as jk

SOURCE = (Path(jk.__file__).parents[1] / "csrc" / jk.SOURCE).read_text()
CONSTS = {k: int(v) for k, v in
          re.findall(r"constexpr int (\w+) = (\d+);", SOURCE)}
MAX_THREADS = 1024  # the kernels' __launch_bounds__
PAIRS_PER_BLOCK = 10  # a cluster block's column pairs, aimed at
MAX_CLUSTER = 8
GROUP_PAIRS = 8  # a group block's column pairs, aimed at
MAX_GROUP = 32
SMEM_OPT_IN = 232448  # dynamic shared memory a block may opt in to


def geometry(m, w=None, k=0):
    """The kernel's launch geometry (``row_pairs``) for block k of w column
    pairs (w = c: one block a matrix): the fewest row pairs J a thread such
    that w * ceil(c / J) threads, rounded up to whole warps, plus w rotation
    makers in whole warps fit in a block. Returns (c, Y, J, threads) and the
    (I, K) blocks the round loops of threads tid = y * w + K (y < Y, K
    below the block's own count of pairs) visit, K as a column pair of the
    matrix."""
    c = m // 2
    w = c if w is None else w
    wk = min(w, c - k * w)
    makers = -(-w // 32) * 32
    J = -(-c * w // MAX_THREADS)
    while True:
        Y = -(-c // J)
        threads = -(-w * Y // 32) * 32 + makers
        if threads <= MAX_THREADS:
            break
        J += 1
    blocks = []
    for tid in range(threads - makers):
        K, y = tid % w, tid // w
        if y < Y and K < wk:
            blocks += [(y + j * Y, k * w + K) for j in range(J)
                       if y + j * Y < c]
    return (c, Y, J, threads), blocks


def split_shape(m, pairs, most):
    """(nb, w) as ``split_shape`` picks them: about ``pairs`` column pairs
    a block, at most ``most`` blocks, and no empty block."""
    c = m // 2
    w = -(-c // min(-(-c // pairs), most))
    return -(-c // w), w


def cluster_shape(m):
    """(nb, w) of the cluster variant (84 < m <= 320)."""
    return split_shape(m, PAIRS_PER_BLOCK, MAX_CLUSTER)


def group_shape(m):
    """(nb, w) of the group variant (m > 320)."""
    return split_shape(m, GROUP_PAIRS, MAX_GROUP)


def test_constants_match_the_cuda_source():
    assert CONSTS["MAX_M"] == jk.MAX_M
    assert CONSTS["SMEM_MAX_M"] == jk.SMEM_MAX_M
    assert CONSTS["CLUSTER_MAX_M"] == jk.CLUSTER_MAX_M
    assert CONSTS["MAX_THREADS"] == MAX_THREADS
    assert CONSTS["PAIRS_PER_BLOCK"] == PAIRS_PER_BLOCK
    assert CONSTS["MAX_CLUSTER"] == MAX_CLUSTER
    assert CONSTS["GROUP_PAIRS"] == GROUP_PAIRS
    assert CONSTS["MAX_GROUP"] == MAX_GROUP
    assert CONSTS["SMEM_OPT_IN"] == SMEM_OPT_IN
    assert CONSTS["RECV_UNROLL"] >= 1  # a group thread's loads in flight
    assert jk.SMEM_MAX_M < jk.CLUSTER_MAX_M < jk.MAX_M


@pytest.mark.parametrize("m", [2, 4, 24, 40, 56, 80, 96, 122, 256, 512])
def test_position_moves_replay_the_tournament(m):
    dst = np.asarray(jk.position_moves(m))
    sigma = np.asarray(tj._tournament_sigma(m))
    assert sorted(dst.tolist()) == list(range(m))
    arr = np.arange(m)      # arrangement by the kernel's table
    ref = np.arange(m)      # arrangement by the plain version's permutation
    seen = set()
    for _ in range(m - 1):
        pairs = {(int(arr[2 * i]), int(arr[2 * i + 1])) for i in range(m // 2)}
        assert pairs == {(int(ref[2 * i]), int(ref[2 * i + 1]))
                         for i in range(m // 2)}
        seen |= {(min(a, b), max(a, b)) for a, b in pairs}
        nxt = np.empty_like(arr)
        nxt[dst] = arr      # position p moves to dst[p]
        arr, ref = nxt, ref[sigma]
    assert len(seen) == m * (m - 1) // 2  # every index pair once a sweep
    assert np.array_equal(arr, np.arange(m))  # identity after m - 1 rounds


@pytest.mark.parametrize("m", [2, 24, 40, 56, 80, 84, 86, 96, 128, 160, 256,
                               288, 320, 322, 384, 448, 512])
def test_thread_geometry_covers_every_block_once(m):
    c = m // 2
    if jk.SMEM_MAX_M < m <= jk.CLUSTER_MAX_M:
        nb, w = cluster_shape(m)
        assert nb <= MAX_CLUSTER and nb * w >= c > (nb - 1) * w
    elif m > jk.CLUSTER_MAX_M:
        nb, w = group_shape(m)
        assert nb <= MAX_GROUP and nb * w >= c > (nb - 1) * w
        assert w == GROUP_PAIRS  # 8 pairs a block: 21 blocks at 322, 32 at 512
    else:
        nb, w = 1, c
    blocks = []
    for k in range(nb):
        (_, Y, J, threads), own = geometry(m, w, k)
        assert threads <= MAX_THREADS and threads % 32 == 0
        assert all(k * w <= K < (k + 1) * w for _, K in own)
        blocks += own
    assert sorted(blocks) == [(I, K) for I in range(c) for K in range(c)]
    if m <= jk.SMEM_MAX_M:
        # one row pair a thread up to m = 56, two on the rest of the QFT path
        assert J == (1 if m <= 56 else 2)
    if m > jk.CLUSTER_MAX_M:  # a group block: 8 column pairs, 2-3 row pairs a thread
        assert J == (3 if m > 448 else 2)
    # the gate path's m = 160 and the largest complex64 solve below cutoff
    # 1e-10, m = 288, both on clusters of 8
    if m in (160, 288):
        assert nb == MAX_CLUSTER


def slot(p, c):
    """Column slot of position p: even positions first, then odd."""
    return (p >> 1) + (p & 1) * c


def rotation(a, d, w):
    """The rotations of pairs with diagonal (a, d) and coupling w, in
    float32, as the kernel computes them."""
    f = np.float32
    absw = np.abs(w).astype(f)
    safe = np.where(absw > 0, absw, f(1))
    tau = (a - d) / (f(2) * safe)
    t = np.where(tau >= 0, f(1), f(-1)) / (np.abs(tau) + np.sqrt(f(1) + tau * tau))
    t = np.where(absw > 0, t, f(0))
    c0 = f(1) / np.sqrt(f(1) + t * t)
    return c0.astype(f), (w * (t * c0 / safe)).astype(w.dtype)


def left(c0, z, gp, gq):
    return c0 * gp + z * gq, c0 * gq - np.conj(z) * gp


def right(c0, z, x0, x1):
    return c0 * x0 + x1 * np.conj(z), -x0 * z + c0 * x1


def entry(G, P, Q, s, t, cP, zP, cQ, zQ, c):
    """Entry (s, t) of J_P^H G[pair P, pair Q] J_Q from the slot layout."""
    x00, x10 = left(cP, zP, G[2 * P, Q], G[2 * P + 1, Q])
    x01, x11 = left(cP, zP, G[2 * P, c + Q], G[2 * P + 1, c + Q])
    y = right(cQ, zQ, np.where(s, x10, x00), np.where(s, x11, x01))
    return np.where(t, y[1], y[0])


def emulate(H, sweeps):
    """The kernel's rounds in numpy (float32 / complex64), in its storage:
    columns in slots, G and V double-buffered, the round's rotations made
    during the previous round from G and that round's rotations."""
    m = H.shape[-1]
    c = m // 2
    dst = np.asarray(jk.position_moves(m))
    src = np.argsort(dst)
    cols = slot(np.arange(m), c)
    _, blocks = geometry(m)
    I, K = np.asarray(blocks).T
    G = np.empty_like(H)
    G[:, cols] = H
    V = np.zeros_like(H)
    V[np.arange(m), cols] = 1
    pair = np.arange(c)
    c0, z = rotation(G[2 * pair, pair].real, G[2 * pair + 1, c + pair].real,
                     G[2 * pair, c + pair])
    sK0, sK1 = slot(dst[2 * K], c), slot(dst[2 * K + 1], c)
    A, sa, B, sb = src[0::2] >> 1, src[0::2] & 1, src[1::2] >> 1, src[1::2] & 1
    rounds = sweeps * (m - 1)
    for r in range(rounds):
        if r + 1 < rounds:  # the makers: next round's diagonal blocks
            nxt = (entry(G, A, A, sa, sa, c0[A], z[A], c0[A], z[A], c),
                   entry(G, B, B, sb, sb, c0[B], z[B], c0[B], z[B], c),
                   entry(G, A, B, sa, sb, c0[A], z[A], c0[B], z[B], c))
        p, q = 2 * I, 2 * I + 1
        x0, xq0 = left(c0[I], z[I], G[p, K], G[q, K])
        x1, xq1 = left(c0[I], z[I], G[p, c + K], G[q, c + K])
        Gn, Vn = np.empty_like(G), np.empty_like(V)
        Gn[dst[p], sK0], Gn[dst[p], sK1] = right(c0[K], z[K], x0, x1)
        Gn[dst[q], sK0], Gn[dst[q], sK1] = right(c0[K], z[K], xq0, xq1)
        for row in (p, q):
            Vn[row, sK0], Vn[row, sK1] = right(c0[K], z[K], V[row, K], V[row, c + K])
        G, V = Gn, Vn
        if r + 1 < rounds:
            # what the makers rebuilt is what the update wrote
            assert np.array_equal(nxt[0], G[2 * pair, pair])
            assert np.array_equal(nxt[1], G[2 * pair + 1, c + pair])
            assert np.array_equal(nxt[2], G[2 * pair, c + pair])
            c0, z = rotation(nxt[0].real, nxt[1].real, nxt[2])
    lam = G[np.arange(m), cols].real
    order = np.argsort(lam, kind="stable")
    return lam[order], V[:, cols[order]]


@pytest.mark.parametrize("complex_", [True, False])
@pytest.mark.parametrize("m,sweeps", [(2, 3), (8, 5), (24, 5), (80, 4)])
def test_emulated_rounds_match_the_plain_version(m, sweeps, complex_):
    rng = np.random.default_rng(m + 1000 * complex_)
    A = rng.normal(size=(m, m)) + (1j * rng.normal(size=(m, m)) if complex_ else 0)
    H = ((A + np.conj(A.T)) / 2).astype(np.complex64 if complex_ else np.float32)
    lam, V = emulate(H, sweeps)
    assert V.dtype == H.dtype
    Ht = torch.from_numpy(H)
    lam_p, V_p = tj.jacobi_eigh(Ht, sweeps=sweeps)
    scale = float(lam_p.abs().max())
    assert np.abs(lam - lam_p.numpy()).max() / scale <= jk.tolerance(m)
    got = jk.figures(Ht, torch.from_numpy(lam.astype(np.float32)),
                     torch.from_numpy(V))
    plain = jk.figures(Ht, lam_p, V_p)
    for k, v in got.items():
        assert v <= jk.rounding_bar(m, plain[k]), (k, v, plain[k])


def slot_block(s, c, w):
    """The cluster block that owns column slot s, and the slot's column in
    that block's rows of 2w (its w even slots, then its odd)."""
    K = s if s < c else s - c
    return K // w, K % w + (0 if s < c else w)


def maker_block(i, m, w, src):
    """The block that makes pair i's rotations (``maker_block``): the one
    holding a column of i's next diagonal block (the columns of pairs A and
    B, whose positions move to i's) that crossed a block edge in the last
    round, else i's owner. Raises where two crossed columns lie in two
    blocks."""
    c = m // 2
    at = None
    for P in (src[2 * i] >> 1, src[2 * i + 1] >> 1):
        for pos in (2 * P, 2 * P + 1):
            held = slot_block(slot(pos, c), c, w)[0]
            if held != (src[pos] >> 1) // w:  # another block's owner wrote it
                assert at in (None, held), f"m={m}: pair {i}"
                at = held
    return i // w if at is None else at


@pytest.mark.parametrize("m", [86, 96, 128, 160, 288, 320])
def test_cluster_edges_one_column_each_way(m):
    """Each cluster block stores at most one column into each neighbour and
    none further; every pair's maker lies in its owner's block or a
    neighbour's, and no block makes more than one warp's worth of pairs:
    what ``maker_block`` and the kernel's maker warp assume."""
    c = m // 2
    nb, w = cluster_shape(m)
    dst = np.asarray(jk.position_moves(m))
    src = np.argsort(dst)
    for k in range(nb):
        owned = range(k * w, min(c, (k + 1) * w))
        out = [slot_block(slot(dst[2 * K + e], c), c, w)[0]
               for K in owned for e in (0, 1)]
        far = sorted(b for b in out if b != k)
        assert far == sorted(set(far)) and all(abs(b - k) == 1 for b in far)
    makers = [maker_block(i, m, w, src) for i in range(c)]
    assert all(abs(mk - i // w) <= 1 for i, mk in enumerate(makers))
    assert max(makers.count(k) for k in range(nb)) <= min(32, w + 2)


def cluster_emulate(H, sweeps):
    """The cluster variant's rounds in numpy, in its storage: block k holds
    rows 0..m-1 of the slots of its column pairs [k w, k w + wk) (nb, w from
    ``cluster_shape``), twice; an owner stores its two output columns in the
    buffers of the blocks that own their next slots; the maker of pair i,
    in block ``maker_block(i)``, reads its pairs' diagonal blocks from the
    blocks that hold them, a column that crossed an edge in the last round
    only in its own block (it is still in flight for every other), and
    writes the next rotation into every block's table and into the log.
    Then the vector pass: V = I in slots, every round's logged rotations
    applied to every row. Returns the eigenvalues ascending and V in their
    order, and the log."""
    m = H.shape[-1]
    c = m // 2
    nb, w = cluster_shape(m)
    L = 2 * w
    dst = np.asarray(jk.position_moves(m))
    src = np.argsort(dst)
    rounds = sweeps * (m - 1)
    owned = [range(k * w, min(c, (k + 1) * w)) for k in range(nb)]
    made = [[i for i in range(c) if maker_block(i, m, w, src) == k]
            for k in range(nb)]
    G = [np.zeros((m, L), H.dtype) for _ in range(nb)]
    for k in range(nb):
        for K in owned[k]:
            G[k][:, K - k * w] = H[:, 2 * K]
            G[k][:, K - k * w + w] = H[:, 2 * K + 1]
    pair = np.arange(c)
    rot = rotation(H[2 * pair, 2 * pair].real, H[2 * pair + 1, 2 * pair + 1].real,
                   H[2 * pair, 2 * pair + 1])
    R = [rot] * nb  # every block makes round 0's rotations itself
    log = [rot]
    I = np.arange(c)
    p, q = 2 * I, 2 * I + 1
    # each block's columns that another block stored there by st.async in
    # the last round: only the holder's own wait orders them
    inbound = [set() for _ in range(nb)]

    def gather(rows, slots, k=None):
        """G at (row, slot) pairs, each from the block that holds the slot;
        as block k's makers read it, when k is given"""
        out = np.empty(len(rows), H.dtype)
        for j, (row, s) in enumerate(zip(rows, slots)):
            kb, lb = slot_block(s, c, w)
            assert k is None or kb == k or lb not in inbound[kb], "in flight"
            out[j] = G[kb][row, lb]
        return out

    def entry_at(P, Q, s, t, k):
        """entry (s, t) of J_P^H G[P, Q] J_Q for arrays of pairs, as
        block k's makers compute it from the blocks that hold Q"""
        (cP, zP), (cQ, zQ) = ((R[k][0][X], R[k][1][X]) for X in (P, Q))
        x00, x10 = left(cP, zP, gather(2 * P, Q, k), gather(2 * P + 1, Q, k))
        x01, x11 = left(cP, zP, gather(2 * P, c + Q, k),
                        gather(2 * P + 1, c + Q, k))
        y = right(cQ, zQ, np.where(s, x10, x00), np.where(s, x11, x01))
        return np.where(t, y[1], y[0])

    for r in range(rounds):
        if r + 1 < rounds:  # the makers of each block
            nxt = np.empty((3, c), H.dtype)
            for k in range(nb):
                i = np.asarray(made[k], dtype=int)
                a, bb = src[2 * i], src[2 * i + 1]
                A, sa, B, sb = a >> 1, a & 1, bb >> 1, bb & 1
                nxt[:, i] = (entry_at(A, A, sa, sa, k), entry_at(B, B, sb, sb, k),
                             entry_at(A, B, sa, sb, k))
        Gn = [np.empty_like(g) for g in G]
        inbound = [set() for _ in range(nb)]
        for k in range(nb):
            c0, z = R[k]
            for K in owned[k]:
                lk = K - k * w
                x0, xq0 = left(c0[I], z[I], G[k][p, lk], G[k][q, lk])
                x1, xq1 = left(c0[I], z[I], G[k][p, lk + w], G[k][q, lk + w])
                ys = right(c0[K], z[K], x0, x1), right(c0[K], z[K], xq0, xq1)
                for e in (0, 1):
                    held, col = slot_block(slot(dst[2 * K + e], c), c, w)
                    Gn[held][dst[p], col] = ys[0][e]
                    Gn[held][dst[q], col] = ys[1][e]
                    if held != k:
                        inbound[held].add(col)
        G = Gn
        if r + 1 < rounds:
            d0, d1, wv = nxt
            # what the makers rebuilt is what the update wrote
            even, odd = slot(2 * pair, c), slot(2 * pair + 1, c)
            assert np.array_equal(d0, gather(2 * pair, even))
            assert np.array_equal(d1, gather(2 * pair + 1, odd))
            assert np.array_equal(wv, gather(2 * pair, odd))
            rot = rotation(d0.real, d1.real, wv)
            R = [rot] * nb
            log.append(rot)
    diag = np.array([G[kb][j, lb].real for j in range(m)
                     for kb, lb in [slot_block(slot(j, c), c, w)]])
    lam, V = vector_pass(H, diag, log[:rounds])
    return lam, V, log


def vector_pass(H, diag, log):
    """The vector pass: V = I in slots, every logged round's rotations
    applied to every row; the eigenvalues (the final diagonal, by
    position) ascending and V in their order."""
    m = H.shape[-1]
    c = m // 2
    dst = np.asarray(jk.position_moves(m))
    cols = slot(np.arange(m), c)
    K = np.arange(c)
    s0, s1 = slot(dst[2 * K], c), slot(dst[2 * K + 1], c)
    V = np.zeros_like(H)
    V[np.arange(m), cols] = 1
    for c0, z in log:
        Vn = np.empty_like(V)
        Vn[:, s0], Vn[:, s1] = right(c0, z, V[:, K], V[:, c + K])
        V = Vn
    order = np.argsort(diag, kind="stable")
    return diag[order], V[:, cols[order]]


@pytest.mark.parametrize("complex_", [True, False])
@pytest.mark.parametrize("m", [96, 160])
def test_cluster_emulation_matches_the_one_block_rounds(m, complex_):
    rng = np.random.default_rng(m + 7 * complex_)
    A = rng.normal(size=(m, m)) + (1j * rng.normal(size=(m, m)) if complex_ else 0)
    H = ((A + np.conj(A.T)) / 2).astype(np.complex64 if complex_ else np.float32)
    lam, V, log = cluster_emulate(H, 1)
    assert len(log) == m - 1 and V.dtype == H.dtype
    lam_1, V_1 = emulate(H, 1)  # the same arithmetic in one block's storage
    assert np.array_equal(lam, lam_1) and np.array_equal(V, V_1)
    # one sweep leaves the eigenvalues unconverged, where the CPU's other
    # rounding moves them further than tolerance(m): the figures are held
    # to rounding_bar, twice the plain version's own
    Ht = torch.from_numpy(H)
    lam_p, V_p = tj.jacobi_eigh(Ht, sweeps=1)
    got = jk.figures(Ht, torch.from_numpy(lam.astype(np.float32)),
                     torch.from_numpy(V))
    plain = jk.figures(Ht, lam_p, V_p)
    for k, v in got.items():
        assert v <= jk.rounding_bar(m, plain[k]), (k, v, plain[k])


def ext_col(s, c, k0, W2):
    """The group block's storage column of slot s (``ext_col``): pair P at
    index P - k0 + 1 of W2 = w + 2, even slots first."""
    return s - k0 + 1 if s < c else s - c - k0 + 1 + W2


def inbox_col(P, odd, n0, wk):
    """The inbox column of pair P's even or odd slot in the block of first
    pair n0 and wk pairs (``inbox_col``)."""
    lp = P - n0 + 1
    return 2 * (lp if lp <= 1 else lp - wk + 2) + odd


def rows_needed(P, n0, wk, m):
    """The rows of pair P's columns that the block of pairs [n0, n0 + wk)
    needs from a neighbour (``rows_needed``): all of an own pair's, of a
    ghost pair's the rows of pairs P - 2 to P + 1."""
    if n0 <= P < n0 + wk:
        return 0, m
    return max(2 * (P - 2), 0), min(2 * (P + 2), m)


def group_plan(m):
    """What each block of the group variant works out once a launch, as the
    kernel does: its first pair and count, the (inbox column, storage
    column, rows) it receives, per own pair its two output columns and the
    neighbour (inbox column, rows) each also goes to, and per own pair the
    (a, bb) its maker reads. Asserts what the kernel traps on: a column
    from a block that is not a neighbour, more than 8 received columns, a
    maker reading outside the storage."""
    c = m // 2
    nb, w = group_shape(m)
    W2 = w + 2
    dst = np.asarray(jk.position_moves(m))
    src = np.argsort(dst)
    plan = []
    for k in range(nb):
        k0, wk = k * w, min(w, c - k * w)
        recv = []
        for lp in range(wk + 2):
            P = k0 - 1 + lp
            for odd in (0, 1):
                if not 0 <= P < c:
                    continue
                kw = (src[2 * P + odd] >> 1) // w
                if kw == k:
                    continue
                col = inbox_col(P, odd, k0, wk)
                assert kw in (k - 1, k + 1) and 0 <= col < 8, (m, k, P)
                recv.append((col, lp + odd * W2, rows_needed(P, k0, wk, m)))
        assert len(recv) <= 8
        outs = []
        for K in range(k0, k0 + wk):
            pair_out = []
            for e in (0, 1):
                s = slot(dst[2 * K + e], c)
                P = s if s < c else s - c
                n = (k - 1 if k > 0 and P <= k0 else
                     k + 1 if k + 1 < nb and P >= k0 + wk - 1 else None)
                lc = ext_col(s, c, k0, W2)
                assert 0 <= lc < 2 * W2 and (lc % W2) <= wk + 1
                wn = None if n is None else min(w, c - n * w)
                box = (None if n is None else
                       (n, inbox_col(P, s >= c, n * w, wn),
                        rows_needed(P, n * w, wn, m)))
                pair_out.append((lc, box))
            outs.append(pair_out)
        makers = []
        for i in range(k0, k0 + wk):
            a, bb = src[2 * i], src[2 * i + 1]
            assert k0 - 1 <= a >> 1 <= k0 + wk and k0 - 1 <= bb >> 1 <= k0 + wk
            makers.append((a, bb))
        plan.append(dict(k0=k0, wk=wk, recv=recv, outs=outs, makers=makers))
    return nb, w, plan


# m of the group variant: every count of pairs in the last block (1 to 8 at
# m = 322 to 336), the tutorials' 384 and 512, and 448, 510
GROUP_MS = list(range(jk.CLUSTER_MAX_M + 2, 338, 2)) + [384, 448, 510, 512]


@pytest.mark.parametrize("m", GROUP_MS)
def test_group_exchange_reaches_neighbours_only(m):
    """Each block of the group variant receives only from its neighbours,
    at most 8 columns, every column it receives is sent to it exactly once
    by the block that writes it, and every storage column is written each
    round by this block or received; what the kernel's traps and inbox
    layout assume."""
    nb, w, plan = group_plan(m)
    W2 = w + 2
    sent = [[] for _ in range(nb)]
    for k, b in enumerate(plan):
        for pair_out in b["outs"]:
            for _, box in pair_out:
                if box is not None:
                    sent[box[0]].append(box[1:])
    for k, b in enumerate(plan):
        assert sorted(sent[k]) == sorted((col, rows)
                                         for col, _, rows in b["recv"]), m
        local = {lc for pair_out in b["outs"] for lc, _ in pair_out}
        got = local | {lc for _, lc, _ in b["recv"]}
        storage = {lp + odd * W2 for lp in range(b["wk"] + 2)
                   for odd in (0, 1) if 0 <= b["k0"] - 1 + lp < m // 2}
        assert got == storage and not local & {lc for _, lc, _ in b["recv"]}
        # a block receives at most 2 full columns and 2 x 8 rows of ghosts
        assert sum(hi - lo for _, _, (lo, hi) in b["recv"]) <= 2 * m + 16


@pytest.mark.parametrize("dtype,size", [("c64", 8), ("f32", 4)])
def test_group_blocks_fit_in_shared_memory(dtype, size):
    """``group_smem`` (storage twice, one round's rotations, dst, src and 33
    ints) and ``vector_smem`` within the opt-in, from the source's own
    constants, for every m of the group variant."""
    rot = 16 if dtype == "c64" else 8  # Rot<E>: c, then z (aligned)
    for m in range(jk.CLUSTER_MAX_M + 2, jk.MAX_M + 1, 2):
        _, w = group_shape(m)
        group = 4 * m * (w + 2) * size + (m // 2) * rot + (2 * m + 33) * 4
        vector = 2 * CONSTS["V_CHUNK"] * (m // 2) * rot \
            + 2 * CONSTS["V_WARPS"] * m * size + 3 * m * 4
        assert group <= SMEM_OPT_IN and vector <= SMEM_OPT_IN, (m, group, vector)


def group_emulate(H, sweeps):
    """The group variant's rounds in numpy, in its storage: block k keeps
    the columns of pairs [k w - 1, k w + wk] (``ext_col``), twice; its
    owners write every output column there and, where a neighbour keeps
    it too, into that neighbour's inbox (parity by the count of rounds);
    its makers make their own pairs' next rotations from its storage alone
    and write them to the log, which every block then reads as the next
    round's table; each block copies what its inbox received into its
    storage (of a ghost pair's columns only the rows its makers read).
    Every round's storage starts as NaN and every inbox column is
    NaN again once read, so a column read before it is written, or never
    sent, shows. Returns the eigenvalues ascending, V in their order and
    the log."""
    m = H.shape[-1]
    c = m // 2
    nb, w, plan = group_plan(m)
    W2, L = w + 2, 2 * (w + 2)
    dst = np.asarray(jk.position_moves(m))
    rounds = sweeps * (m - 1)
    nan = np.asarray(np.nan, H.dtype)
    G = []
    for k, b in enumerate(plan):
        g = np.full((m, L), nan)
        for lp in range(b["wk"] + 2):
            P = b["k0"] - 1 + lp
            if 0 <= P < c:
                g[:, lp], g[:, lp + W2] = H[:, 2 * P], H[:, 2 * P + 1]
        G.append(g)
    pair = np.arange(c)
    rot = rotation(H[2 * pair, 2 * pair].real, H[2 * pair + 1, 2 * pair + 1].real,
                   H[2 * pair, 2 * pair + 1])
    log = [rot]
    inbox = np.full((nb, 2, 8, m), nan)
    I = np.arange(c)
    p, q = 2 * I, 2 * I + 1
    seq = 0

    def entry_at(g, k0, P, Q, s, t, R):
        """entry (s, t) of J_P^H G[P, Q] J_Q from a block's storage"""
        (cP, zP), (cQ, zQ) = ((R[0][X], R[1][X]) for X in (P, Q))
        lq = Q - k0 + 1
        x00, x10 = left(cP, zP, g[2 * P, lq], g[2 * P + 1, lq])
        x01, x11 = left(cP, zP, g[2 * P, lq + W2], g[2 * P + 1, lq + W2])
        y = right(cQ, zQ, np.where(s, x10, x00), np.where(s, x11, x01))
        return np.where(t, y[1], y[0])

    for r in range(rounds):
        seq += 1
        par = seq & 1
        nxt = np.empty((3, c), H.dtype)
        Gn = [np.full((m, L), nan) for _ in range(nb)]
        c0, z = log[-1]  # every block's table: this round's log entry
        for k, b in enumerate(plan):
            k0, wk = b["k0"], b["wk"]
            if r + 1 < rounds:  # the makers, from this block's storage
                a, bb = np.asarray(b["makers"]).T
                A, sa, B, sb = a >> 1, a & 1, bb >> 1, bb & 1
                i = np.arange(k0, k0 + wk)
                nxt[:, i] = (entry_at(G[k], k0, A, A, sa, sa, log[-1]),
                             entry_at(G[k], k0, B, B, sb, sb, log[-1]),
                             entry_at(G[k], k0, A, B, sa, sb, log[-1]))
            # the owners: every row pair I against each own column pair K
            K = np.arange(k0, k0 + wk)
            lk = K - k0 + 1
            ci, zi = c0[I][:, None], z[I][:, None]
            x0, xq0 = left(ci, zi, G[k][p][:, lk], G[k][q][:, lk])
            x1, xq1 = left(ci, zi, G[k][p][:, lk + W2], G[k][q][:, lk + W2])
            ys = right(c0[K], z[K], x0, x1), right(c0[K], z[K], xq0, xq1)
            for j, pair_out in enumerate(b["outs"]):
                for e, (lc, box) in enumerate(pair_out):
                    Gn[k][dst[p], lc] = ys[0][e][:, j]
                    Gn[k][dst[q], lc] = ys[1][e][:, j]
                    if box is not None:  # only the rows the neighbour needs
                        n, col, (lo, hi) = box
                        for rows, y in ((dst[p], ys[0][e][:, j]),
                                        (dst[q], ys[1][e][:, j])):
                            at = (rows >= lo) & (rows < hi)
                            inbox[n, par, col, rows[at]] = y[at]
        # every block published; each reads its inbox
        for k, b in enumerate(plan):
            for col, lc, (lo, hi) in b["recv"]:
                Gn[k][lo:hi, lc] = inbox[k, par, col, lo:hi]
                inbox[k, par, col] = nan
        G = Gn
        if r + 1 < rounds:
            rot = rotation(nxt[0].real, nxt[1].real, nxt[2])
            log.append(rot)
    diag = np.empty(m, np.float32)
    for k, b in enumerate(plan):
        for K in range(b["k0"], b["k0"] + b["wk"]):
            lk = K - b["k0"] + 1
            diag[2 * K] = G[k][2 * K, lk].real
            diag[2 * K + 1] = G[k][2 * K + 1, lk + W2].real
    lam, V = vector_pass(H, diag, log[:rounds])
    return lam, V, log


@pytest.mark.parametrize("complex_", [True, False])
@pytest.mark.parametrize("m", [322, 384])
def test_group_emulation_matches_the_one_block_rounds(m, complex_):
    rng = np.random.default_rng(m + 11 * complex_)
    A = rng.normal(size=(m, m)) + (1j * rng.normal(size=(m, m)) if complex_ else 0)
    H = ((A + np.conj(A.T)) / 2).astype(np.complex64 if complex_ else np.float32)
    lam, V, log = group_emulate(H, 1)
    assert len(log) == m - 1 and V.dtype == H.dtype
    assert np.isfinite(lam).all() and np.isfinite(V).all()
    lam_1, V_1 = emulate(H, 1)  # the same arithmetic in one block's storage
    assert np.array_equal(lam, lam_1) and np.array_equal(V, V_1)
