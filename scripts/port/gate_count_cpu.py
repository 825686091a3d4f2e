"""The gate path's K2 launches, counted on the CPU.

    python scripts/port/gate_count_cpu.py [n ...]    (default n = 20 30)

Runs what ``chip_smoke.py``'s gate phases run at each n, with
``complexlinalg.FORCE_DEVICE_PATH`` set so every factorization takes the
card's route, in complex64 at cutoff 1e-9 with chi 128 (factor bucket 32):

* the factor fold of ``build_zt_mpo`` (``compose_layers`` on what
  ``zt._factor_stacks`` gives: Part 1, Part 2 and the paired-QFT stack
  folded as one batched program), then the factor build whole (the fold
  again, and Part 2 after Part 1) and the fuse (``zt._fuse_factors``);
* the same three stacks folded one after the other through the unbatched
  ``compose_layers``, as the port did before the fold was batched;
* for n <= 24, the encode of the gate pole search (phase 10: TT-SVD of
  x_j = e^{-1.6e-4 j} sin(4.08e-3 j), cutoff 1e-12, maxdim 128), split into
  the signal MPS's own splits and the ZTMPS fan-out split.

The eigensolver is ``batch_count_cpu.eigh``, a float64 ``torch.linalg.eigh``
stand-in that counts each call in ``jacobi_eigh_k2.launches`` and
``.by_shape`` as the card's wrapper does, so the shapes, batch sizes and
sweep counts are the ones K2 would be launched with; the values are not
the card's. Prints the launches by (dtype, m, B, sweeps) of each part and
its host seconds (host figures only, four torch threads: no device time).
"""

from __future__ import annotations

import collections
import math
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import qilaplace_tpu_torch as qt  # noqa: E402
import qilaplace_tpu_torch.signals.encode as tenc  # noqa: E402
import qilaplace_tpu_torch.transforms.zt as tzt  # noqa: E402
from batch_count_cpu import take_the_cards_route  # noqa: E402
from qilaplace_tpu_torch.ops.apply import compose_layers  # noqa: E402
from qilaplace_tpu_torch.ops.jacobi_kernels import jacobi_eigh_k2  # noqa: E402
from qilaplace_tpu_torch.utils.config import bucket_for  # noqa: E402

CUTOFF, CHI = 1e-9, 128
POLE_LAM, POLE_W = 1.6e-4, 4.08e-3
CPU = torch.device("cpu")


def counted(what, fn):
    """Run ``fn``; print the launches by shape that it made."""
    before = collections.Counter(jacobi_eigh_k2.by_shape)
    t0 = time.perf_counter()
    out = fn()
    secs = time.perf_counter() - t0
    made = jacobi_eigh_k2.by_shape - before
    shapes = ", ".join(f"({k} m={m}, B={B}, sweeps={sw}): {c}" for
                       (m, B, k, sw), c in sorted(made.items()))
    print(f"  {what}: {sum(made.values())} launches in {secs:.1f} s "
          f"[{shapes}]", flush=True)
    return out


def build(n):
    print(f"n = {n}: build_zt_mpo(cutoff {CUTOFF:g}, chi {CHI}), complex64",
          flush=True)
    args = dict(cutoff=CUTOFF, maxdim=CHI, chi_f=bucket_for(32),
                dtype=torch.complex64, chi_work_f=None, device=CPU)
    acc, lay_c, lay_r, kw = tzt._factor_stacks(n, 2 * math.pi, **args)
    S = lay_c.shape[0]
    counted(f"factor fold, {S} stacks batched",
            lambda: compose_layers(acc, lay_c, lay_r, **kw))
    W_dt, W_qft = counted("factor build (fold + Part 2 after Part 1)",
                          lambda: tzt._build_factors_concurrent(
                              n, 2 * math.pi, **args))
    counted("fuse", lambda: tzt._fuse_factors(
        W_dt, W_qft, chi=CHI, cutoff=CUTOFF, maxdim=CHI))

    def one_by_one():
        for s in range(S):
            compose_layers(qt.MPO(cores=acc.cores[s], ranks=acc.ranks[s]),
                           lay_c[s], lay_r[s], **kw)

    counted("the stacks folded one after the other (unbatched)", one_by_one)


def encode(n):
    N = 2**n
    j = torch.arange(N, dtype=torch.float64)
    x = (torch.exp(-POLE_LAM * j) * torch.sin(POLE_W * j)).float()
    print(f"n = {n}: signal_ztmps (TT-SVD, cutoff 1e-12, maxdim {CHI})",
          flush=True)
    real_split = tenc.svd_split

    def split(M, **kw):
        if M.dim() == 3:  # the fan-out: every site in one call
            return counted(f"ZTMPS fan-out split of {M.shape[0]} sites",
                           lambda: real_split(M, **kw))
        return real_split(M, **kw)

    tenc.svd_split = split
    try:
        counted("signal_ztmps, whole", lambda: qt.signal_ztmps(
            x, cutoff=1e-12, maxdim=CHI, device=CPU))
    finally:
        tenc.svd_split = real_split


def main() -> None:
    ns = [int(a) for a in sys.argv[1:]] or [20, 30]
    torch.set_num_threads(4)
    take_the_cards_route()
    for n in ns:
        build(n)
        if n <= 24:
            encode(n)


if __name__ == "__main__":
    main()
