"""The float32 device route of the zT gate build, measured on the CPU.

Usage (from the repository root):

    python scripts/port/gate_device_route.py errors [n]   # default n = 6
    python scripts/port/gate_device_route.py shapes [n]   # default n = 5

``errors``: ``build_zt_mpo(n, 2 pi, cutoff=1e-9)`` of each package on its
device route (``FORCE_DEVICE_PATH``: every eigensolve on the Jacobi
solver, as on the accelerator) in complex64, against the same package's
complex128 build on LAPACK: max |delta| / max |entry| of the dense
operators, and the bonds of both. The JAX package runs on the CPU in x64.

``shapes``: the eigensolve sizes of the port's device route at a tight
cutoff (1e-12, chi 128, complex64), counted by replacing the route's
eigensolver with LAPACK (the sizes do not depend on the solver): what K2
would be handed on the card.
"""

import collections
import math
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
WR = 2 * math.pi


def port_errors(n):
    import torch

    import qilaplace_tpu_torch as qt
    import qilaplace_tpu_torch.ops.complexlinalg as cl

    ref = qt.build_zt_mpo(n, WR, cutoff=1e-9, device="cpu")
    cl.FORCE_DEVICE_PATH = True
    try:
        W = qt.build_zt_mpo(n, WR, cutoff=1e-9, dtype=torch.complex64,
                            device="cpu")
    finally:
        cl.FORCE_DEVICE_PATH = False
    D = qt.mpo_to_dense(W).numpy().astype(np.complex128)
    R = qt.mpo_to_dense(ref).numpy()
    return (np.abs(D - R).max() / np.abs(R).max(), W.chain.ranks.tolist(),
            ref.chain.ranks.tolist())


def jax_errors(n):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import qilaplace_tpu as qj
    import qilaplace_tpu.ops.complexlinalg as cl

    ref = qj.build_zt_mpo(n, WR, cutoff=1e-9)
    cl.FORCE_DEVICE_PATH = True
    jax.clear_caches()
    W = qj.build_zt_mpo(n, WR, cutoff=1e-9, dtype=np.complex64)
    D = np.asarray(qj.mpo_to_dense(W)).astype(np.complex128)
    R = np.asarray(qj.mpo_to_dense(ref))
    return (np.abs(D - R).max() / np.abs(R).max(),
            np.asarray(W.chain.ranks).tolist(),
            np.asarray(ref.chain.ranks).tolist())


def tight_shapes(n):
    import torch

    import qilaplace_tpu_torch as qt
    import qilaplace_tpu_torch.ops.complexlinalg as cl

    count = collections.Counter()

    def counting_eigh(H, *, sweeps=None):
        count[H.shape[-1]] += 1
        return torch.linalg.eigh(H)

    cl._device_eigh, cl.FORCE_DEVICE_PATH = counting_eigh, True
    qt.build_zt_mpo(n, WR, cutoff=1e-12, maxdim=128, chi=128,
                    dtype=torch.complex64, device="cpu")
    return dict(sorted(count.items()))


def main():
    what = sys.argv[1] if len(sys.argv) > 1 else "errors"
    if what == "errors":
        n = int(sys.argv[2]) if len(sys.argv) > 2 else 6
        for name, fn in (("port", port_errors), ("jax", jax_errors)):
            t0 = time.perf_counter()
            err, ranks, ranks_ref = fn(n)
            print(f"{name} n={n}: device route (complex64) vs complex128 "
                  f"max_rel {err:.3e}; bonds {ranks} vs {ranks_ref} "
                  f"({time.perf_counter() - t0:.0f} s on the CPU)",
                  flush=True)
    elif what == "shapes":
        n = int(sys.argv[2]) if len(sys.argv) > 2 else 5
        sizes = tight_shapes(n)
        print(f"port n={n} cutoff 1e-12 complex64: eigensolves by m {sizes};"
              f" largest m {max(sizes)}")
    else:
        sys.exit(f"unknown mode {what!r}; use 'errors' or 'shapes'")


if __name__ == "__main__":
    main()
