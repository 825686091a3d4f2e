"""Whether a batched fold's slots, and batched plain ops, round as one
matrix alone does, on the card.

    python scripts/port/fold_batch_diff.py [n ...]    (default n = 6)

For each n: the zT build's factor stacks (``zt._factor_stacks``: wr = 2 pi,
cutoff 1e-9, factor bucket 32, complex64) folded on the card as one
batched ``compose_layers`` call and then each alone through the unbatched
call, with every eigensolve's input recorded. Prints, per slot, the first
eigensolve whose input differs bit for bit from the stack-alone fold's
(its index, shape and relative size), and the cores' largest difference
relative to the largest entry, bit-identity and bonds.

Then the plain ops of a fold on random complex64 inputs at its shapes,
each taken on a batch of 3 and on each matrix alone: whether every slot
of the plain batched call, and of ``complexlinalg.per_slot`` (what the
port calls on the card), is bit-identical to the matrix alone. Needs a
CUDA card; imports no JAX.
"""

from __future__ import annotations

import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import qilaplace_tpu_torch  # noqa: E402,F401  (sets full-fp32 matmuls)
import qilaplace_tpu_torch.ops.complexlinalg as tcl  # noqa: E402
import qilaplace_tpu_torch.ops.truncation as ttr  # noqa: E402
from qilaplace_tpu_torch.core.mpo import MPO  # noqa: E402
from qilaplace_tpu_torch.ops.apply import compose_layers  # noqa: E402
from qilaplace_tpu_torch.transforms.zt import _factor_stacks  # noqa: E402


def inputs_of_eigensolves(fn):
    """fn() and the input of every eigensolve it made."""
    real, seen = tcl._device_eigh, []

    def eigh(H, **kw):
        seen.append(H.clone())
        return real(H, **kw)

    tcl._device_eigh = ttr._device_eigh = eigh
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        tcl._device_eigh = ttr._device_eigh = real
    return out, seen


def compare_slots(n, dev):
    acc, lay_c, lay_r, kw = _factor_stacks(
        n, 2 * math.pi, cutoff=1e-9, maxdim=32, chi_f=32,
        dtype=torch.complex64, chi_work_f=None, device=dev)
    out, batched = inputs_of_eigensolves(
        lambda: compose_layers(acc, lay_c, lay_r, **kw))
    print(f"n = {n}: {lay_c.shape[0]} stacks, {len(batched)} eigensolves",
          flush=True)
    for s in range(lay_c.shape[0]):
        ref, alone = inputs_of_eigensolves(lambda: compose_layers(
            MPO(cores=acc.cores[s], ranks=acc.ranks[s]), lay_c[s], lay_r[s],
            **kw))
        first = next(((j, tuple(Ha.shape), float(
            (Hb[s] - Ha).abs().max() / Ha.abs().max().clamp_min(1e-30)))
            for j, (Hb, Ha) in enumerate(zip(batched, alone))
            if not torch.equal(Hb[s], Ha)), None)
        gap = float((out.cores[s] - ref.cores).abs().max()
                    / ref.cores.abs().max())
        print(f"  slot {s}: first eigensolve input that differs "
              f"(index, shape, rel): {first}; cores {gap:.3e} apart, "
              f"bit-identical {torch.equal(out.cores[s], ref.cores)}; bonds "
              f"{out.ranks[s].tolist()}, alone {ref.ranks.tolist()}",
              flush=True)


def probe_ops(dev, chi=32, cl=4, S=3):
    """Each plain op of a fold: batched and per_slot against alone."""
    g = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape):
        return torch.randn(*shape, dtype=torch.complex64, device=dev,
                           generator=g)

    w = 2 * chi
    mm = torch.matmul
    cases = {
        "zip einsum": (lambda *t: torch.einsum(
            "...xba,...botc,...atid->...xoicd", *t),
            [(w, cl, chi), (cl, 2, 2, cl), (chi, 2, 2, chi)], (3, 4, 4)),
        "Gram M M^H": (lambda m: mm(m, m.mH), [(w, 2 * w)], 2),
        "Gram M^H M": (lambda m: mm(m.mH, m), [(4 * w, w)], 2),
        "two-site einsum": (lambda *t: torch.einsum(
            "...lsa,...atr->...lstr", *t), [(chi, 4, chi)] * 2, 3),
        "row norms": (lambda m: torch.linalg.vector_norm(m, dim=-1),
                      [(w, 2 * w)], 2),
        "column norms": (lambda m: torch.linalg.vector_norm(m, dim=-2),
                         [(4 * w, w)], 2),
        "suffix sums": (lambda p: p.abs().flip(-1).cumsum(-1).flip(-1),
                        [(w,)], 1),
        "squared mass": (lambda m: (m.abs() ** 2).sum(dim=(-2, -1)),
                         [(4 * w, w)], 2),
    }
    for name, (fn, shapes, core) in cases.items():
        xs = [rnd(S, *sh) for sh in shapes]
        alone = [fn(*[x[s] for x in xs]) for s in range(S)]
        for how, got in (("batched", fn(*xs)),
                         ("per_slot", tcl.per_slot(fn, *xs, core=core))):
            torch.cuda.synchronize()
            same = all(torch.equal(got[s], alone[s]) for s in range(S))
            gap = max(float((got[s] - alone[s]).abs().max()
                            / alone[s].abs().max()) for s in range(S))
            print(f"  {name}, {how}: every slot bit-identical to the matrix "
                  f"alone {same} (largest rel diff {gap:.2e})", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("fold_batch_diff: needs a CUDA card")
    dev = torch.device("cuda", 0)
    for n in [int(a) for a in sys.argv[1:]] or [6]:
        compare_slots(n, dev)
    print("plain ops at the fold's shapes (complex64, random, batch of 3):")
    probe_ops(dev)


if __name__ == "__main__":
    main()
