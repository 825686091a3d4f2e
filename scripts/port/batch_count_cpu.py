"""The batched QFT path's eigensolves, counted on the CPU.

    python scripts/port/batch_count_cpu.py [n]    (default n = 16)

Runs ``chip_smoke.py``'s batched configuration at a size the host can
take: ``build_qft_mpo(n, chi=64, cutoff=1e-9)`` in complex64, 8 signals
x_j = sin((b + 1) j / N), ``batched_qft_pipeline`` at chi 64, cutoff 1e-9,
with ``complexlinalg.FORCE_DEVICE_PATH`` set, so every factorization takes
the card's route. The eigensolver there is ``eigh``, a float64
``torch.linalg.eigh`` stand-in (float32 LAPACK fails to converge on the
encode's degenerate Gram matrices, and the plain Jacobi solver takes
minutes) that counts each call as the card's wrapper counts a K2 launch,
so the shapes, batch sizes and sweep counts are the ones kernel K2 would
be launched with, and the values are not the card's
(``gate_count_cpu.py`` uses it too). Prints K2's launches by
(m, B, dtype, sweeps) for the batch and for one signal, and each row's
largest difference from the one-signal path
``coefficient_batch(apply(W, signal_mps(x_b)))``, relative to its peak, at
the 4096 frequencies of ``chip_smoke.qft_freqs``. Host figures only (four
torch threads): no device time.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import qilaplace_tpu_torch as qt  # noqa: E402
import qilaplace_tpu_torch.ops.complexlinalg as tcl  # noqa: E402
import qilaplace_tpu_torch.ops.truncation as ttr  # noqa: E402
from qilaplace_tpu_torch.ops.jacobi import default_sweeps  # noqa: E402
from qilaplace_tpu_torch.ops.jacobi_kernels import jacobi_eigh_k2  # noqa: E402
from qilaplace_tpu_torch.parallel import batched_qft_pipeline  # noqa: E402
from qilaplace_tpu_torch.utils.bits import tensor_int_to_bits  # noqa: E402

CHI, CUTOFF, BATCH = 64, 1e-9, 8


def eigh(H, *, sweeps=None):
    """float64 LAPACK, counted in ``jacobi_eigh_k2.launches`` and
    ``.by_shape[(m, B, dtype, sweeps)]`` as a K2 launch of H's shape."""
    m = H.shape[-1]
    kind = "c64" if H.is_complex() else "f32"
    jacobi_eigh_k2.launches += 1
    jacobi_eigh_k2.by_shape[(m, H[..., 0, 0].numel(), kind,
                             default_sweeps(m) if sweeps is None
                             else sweeps)] += 1
    wide = torch.complex128 if H.is_complex() else torch.float64
    lam, V = torch.linalg.eigh(H.to(wide))
    return lam.to(H.real.dtype), V.to(H.dtype)


def take_the_cards_route() -> None:
    """Every factorization on the CPU takes the card's route, with its
    eigensolves on the counted stand-in ``eigh``."""
    tcl._device_eigh = ttr._device_eigh = eigh
    tcl.FORCE_DEVICE_PATH = True


def main() -> None:
    from chip_smoke import qft_freqs

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    torch.set_num_threads(4)
    calls = jacobi_eigh_k2.by_shape
    take_the_cards_route()
    N = 2**n
    W = qt.build_qft_mpo(n, chi=CHI, cutoff=CUTOFF, dtype=torch.complex64,
                         device="cpu")
    j = torch.arange(N, dtype=torch.float64)
    xs = torch.stack([torch.sin((b + 1) * j / N)
                      for b in range(BATCH)]).float()
    configs = tensor_int_to_bits(torch.from_numpy(qft_freqs(n)), n,
                                 order="lsb").to(torch.int32)

    def one_signal(x):
        psi = qt.signal_mps(x, cutoff=CUTOFF, chi=CHI, device="cpu")
        out = qt.apply(W, psi, maxdim=CHI, cutoff=CUTOFF)
        return qt.coefficient_batch(out, configs)

    runs = {"batch": lambda: batched_qft_pipeline(
        W, xs, configs, chi=CHI, cutoff=CUTOFF, device="cpu"),
        "one signal": lambda: one_signal(xs[0])}
    for name, run in runs.items():
        calls.clear()
        out = run()
        print(f"{name}: {sum(calls.values())} launches: " + ", ".join(
            f"({k} m={m}, B={B}, sweeps={sw}): {c}"
            for (m, B, k, sw), c in sorted(calls.items())))
        if name == "batch":
            batch = out
    diffs = []
    for b in range(BATCH):
        one = one_signal(xs[b])
        diffs.append(float((batch[b] - one).abs().max() / one.abs().max()))
    print("rows vs one signal, rel to peak: "
          + ", ".join(f"{d:.3e}" for d in diffs))


if __name__ == "__main__":
    main()
