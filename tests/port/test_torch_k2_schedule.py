"""Kernel K2's schedule and index arithmetic, replayed on the CPU.

The kernel (csrc/jacobi_eigh.cu) reads one table from the wrapper,
``jacobi_kernels.position_moves(m)``: each round writes position p's
entries to position ``dst[p]`` of the next round's buffer. These tests
replay that table in numpy against the plain version's tournament
(``_tournament_sigma``), mirror the kernel's launch geometry (thread
tid = y * c + K takes the blocks (I, K) for I = y, y + Y, ...; whole warps
after those make the rotations), and run a numpy emulation of its rounds
(columns stored even positions first, double buffer, stores at the next
positions, each round's rotations rebuilt from the previous G and
rotations) against the plain torch solver.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from qilaplace_tpu_torch.ops import jacobi as tj
from qilaplace_tpu_torch.ops import jacobi_kernels as jk

MAX_THREADS = 1024  # the kernel's __launch_bounds__


def geometry(m):
    """The kernel's launch geometry (``row_pairs``): the fewest row pairs
    J a thread such that c * ceil(c / J) threads, rounded up to whole warps,
    plus c rotation makers in whole warps fit in a block. Returns
    (c, Y, J, threads) and the (I, K) blocks the round loops of threads
    tid = y * c + K (y < Y) visit."""
    c = m // 2
    makers = -(-c // 32) * 32
    J = -(-c * c // MAX_THREADS)
    while True:
        Y = -(-c // J)
        threads = -(-c * Y // 32) * 32 + makers
        if threads <= MAX_THREADS:
            break
        J += 1
    blocks = []
    for tid in range(threads - makers):
        K, y = tid % c, tid // c
        blocks += [(y + j * Y, K) for j in range(J) if y < Y and y + j * Y < c]
    return (c, Y, J, threads), blocks


def test_constants_match_the_cuda_source():
    src = (Path(jk.__file__).parents[1] / "csrc" / jk.SOURCE).read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["MAX_M"]) == jk.MAX_M
    assert int(consts["SMEM_MAX_M"]) == jk.SMEM_MAX_M
    assert int(consts["MAX_THREADS"]) == MAX_THREADS


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


@pytest.mark.parametrize("m", [2, 24, 40, 56, 80, 84, 86, 256, 512])
def test_thread_geometry_covers_every_block_once(m):
    (c, Y, J, threads), blocks = geometry(m)
    assert threads <= MAX_THREADS and threads % 32 == 0
    assert sorted(blocks) == [(I, K) for I in range(c) for K in range(c)]
    # one row pair a thread up to m = 56, two on the rest of the QFT path
    assert J == (1 if m <= 56 else 2) if m <= 84 else J >= 2


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
