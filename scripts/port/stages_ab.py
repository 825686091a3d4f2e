"""Stage times of two checkouts of the port, on one CUDA card, in turns.

    python scripts/port/stages_ab.py BEFORE_ROOT AFTER_ROOT [--runs 2]

Each root is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
The checkouts run in the order before, after, after, before, each in a
process of its own that builds its kernels, makes one warm-up run and then
``--runs`` timed runs of two configurations ``chip_smoke.py`` drives, each
stage synchronised and timed on the host clock: the QFT path
(QFTPipeline(28, chi=64, cutoff=1e-9), rsvd encode k=50 p=5 q=2, zip-up
apply) and the gate path of the n=20 pole search (TT-SVD encode of its
signal, zt_mpo(20, 2 pi, engine="gate", cutoff=1e-9, maxdim=128) in
complex64, the zip-up apply at chi 128). One JSON line per process: the
root, its stage times (the median run), the K2 launches of one run and the
first 16 hex digits of the SHA-256 of the gate operator's cores and ranks
in every run (equal digests: bit-identical builds). The card's name and
power limit lead the output.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys
import time

N_BITS, CHI, CUTOFF = 28, 64, 1e-9
ENCODE = dict(method="rsvd", k=50, p=5, q=2)
GATE_BITS, GATE_CHI = 20, 128
POLE_LAM, POLE_W = 1.6e-4, 4.08e-3  # the pole search's e^{-lam j} sin(w j)


def worker(root: str, runs: int) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import qilaplace_tpu_torch as qt
    from qilaplace_tpu_torch.ops.jacobi_kernels import jacobi_eigh_k2

    dev = torch.device("cuda", 0)

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    x = qt.generate_signal(N_BITS, device=dev)
    j = torch.arange(2**GATE_BITS, dtype=torch.float64, device=dev)
    x_gate = (torch.exp(-POLE_LAM * j) * torch.sin(POLE_W * j)).float()

    def one_run():
        pipe, t_build = synced(lambda: qt.QFTPipeline(
            N_BITS, chi=CHI, cutoff=CUTOFF, device=dev))
        psi, t_enc = synced(lambda: pipe.encode(x, **ENCODE))
        _, t_apply = synced(lambda: pipe.forward(psi))
        psi_g, t_genc = synced(lambda: qt.signal_ztmps(
            x_gate, cutoff=1e-12, maxdim=GATE_CHI, device=dev))
        W, t_gbuild = synced(lambda: qt.zt_mpo(
            GATE_BITS, 2 * math.pi, engine="gate", cutoff=CUTOFF,
            maxdim=GATE_CHI, dtype=torch.complex64, cache=False, device=dev))
        _, t_gapply = synced(lambda: qt.apply(W, psi_g, maxdim=GATE_CHI,
                                              cutoff=CUTOFF))
        digests.add(hashlib.sha256(
            W.chain.cores.cpu().numpy().tobytes()
            + W.chain.ranks.cpu().numpy().tobytes()).hexdigest()[:16])
        return dict(build_s=t_build, encode_s=t_enc, apply_s=t_apply,
                    gate_encode_s=t_genc, gate_build_s=t_gbuild,
                    gate_apply_s=t_gapply)

    digests = set()
    one_run()  # warm-up: kernel builds, allocator
    jacobi_eigh_k2.launches = 0
    stages = [one_run()]
    launches = jacobi_eigh_k2.launches
    stages += [one_run() for _ in range(runs - 1)]
    med = sorted(stages, key=lambda s: sum(s.values()))[len(stages) // 2]
    print(json.dumps(dict(root=root, runs=runs, k2_launches=launches,
                          gate_build_sha256=sorted(digests),
                          **{k: float(np.float64(v)) for k, v in med.items()},
                          all_runs=stages)), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("before")
    ap.add_argument("after", nargs="?")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args()
    if args.worker:
        worker(args.before, args.runs)
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    for root in (args.before, args.after, args.after, args.before):
        subprocess.run([sys.executable, os.path.abspath(__file__), root,
                        "--worker", "--runs", str(args.runs)], check=True,
                       timeout=900)


if __name__ == "__main__":
    main()
