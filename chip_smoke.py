"""Smoke run of the PyTorch port (qilaplace_tpu_torch) on one CUDA card.

Drives the port's paths (the n=30 zT scan, the QFT spectrum, the gate-built
zT and DT operators with the apply-then-read pole search, the batched path,
the tutorials) at full size and checks them:

1. env       torch / CUDA versions, the card, its power limit;
2. build     kernels K1 and K2 from qilaplace_tpu_torch/csrc and K2's
             exchange primitives (scripts/port/k2_primitives.cu), one nvcc
             each, in parallel (sm_90a); registers, shared memory and
             spills; then the primitives timed alone (CUDA events): a flag
             round trip through L2 between two blocks, and the group
             variant's round without its arithmetic (flags, or one
             counter, across 16 / 24 / 32 co-resident blocks, with and
             without the columns it sends at m = 512);
3. K1 check  K1 against its plain torch version (run in complex128) on the
             card: the zT path's shape (60 sites, chi 256, the 4096 scan
             configurations), a chi=8 chain with B=5, a chi=32 chain with
             B=1000, the ragged chains of the K1 GPU tests
             (tests/port/port_helpers.py: bond ranks zero-padded to chi with
             dead lanes in the middle of bonds, widths off the 64-column
             tile; B = 1, 33, 4097; all rows bit 0, all bit 1); tolerance
             max |delta| / max |ref| <= 1e-5; and the same chain with extra
             dead lanes (chi 128 inside chi 256) read bit-identically;
4. K2 check  K2 against its plain torch version (same sweeps, same dtype, on
             the card; the share of bit-identical entries is logged) on
             seeded Hermitian inputs: the QFT path's shapes at
             its sweep counts (c64 m = 24, 40, 80; f32 m = 56, B = 1 and 8),
             the route's edges at default sweeps (m = 2, 84 = the largest
             shared-memory m, 86 = the smallest on a cluster, 256, 320 =
             the largest on a cluster, 322 = the smallest on a group, 384,
             448, 512; B = 4), the cluster variant's largest complex64
             solve below cutoff 1e-10 (m = 288, B = 1, 7 sweeps) and its
             real variant (f32 m = 160, 6 sweeps), the group variant's real
             variant (f32 m = 512, 7 sweeps), a clustered spectrum
             (default and 12 sweeps) and a zero-padded input; then the
             cluster and group variants with more clusters or groups than
             the card holds at once (c64 m = 160 and 288, B = 132; m = 384,
             B = 11; m = 512, B = 9; 7 sweeps, 3 launches each):
             eigenvalues bit-identical to the plain version in every run,
             V equal in every run. Eigenvalues
             against the plain version within jacobi_kernels.tolerance
             (1e-5, 5e-5 from m = 256); V^H V - I, the residual and the
             eigenvalues against float64 eigh within the same bar, or
             twice the plain version's own figure on the same input where
             that is larger (jacobi_kernels.rounding_bar; both figures are
             logged);
4b. readout  the readout routes on the card, n = 8: a complex128 state
             through chi_grid_direct, ZTPipeline.chi_grid_direct,
             coarse_to_fine_pole_search(readout="direct") and
             QFTPipeline.spectrum, and chi = 264 chains (complex128 and
             complex64) through spectrum, each against the same call on the
             CPU (1e-10 relative; the complex64 chain against the CPU's
             complex128 read, 1e-5); K1 must not launch;
5. zT path n=30: cross encode of the sin_decay signal, analytic build of
             the zT factor pack, assembly on the card, direct readout of
             the 4096 scan points (zipper_chain + K1), scored against the
             closed-form oracle; then the multi_sin_exp family through the
             same entry point (the factored route). Median of 3 after a
             warm-up; K1 launches counted over the path;
6. pole      ZTPipeline(30).find_poles(readout="direct"); the pole must lie
             within 64 * 2 pi / N of e^{-lambda +- i w};
7. QFT path n=28: QFTPipeline(28, chi=64, cutoff=1e-9) on the sin signal
             (2^28 float32 samples, made on the card): rsvd encode (k=50,
             p=5, q=2), the gate-built QFT operator, the zip-up apply and a
             K1 readout at 4096 frequencies, each stage timed (the faster
             of 2 runs after a warm-up; at n=16 the median of 3), scored
             against the closed-form DFT; K1 and K2 launches and plain
             Jacobi calls on the card counted over the path; error bar
             0.1 (a broken path, not the device route's f32 accuracy);
             the readout (K1 at the output state's chi 64) against K1's
             plain version in complex128 within 1e-5; then
             n=16 with the bar 8e-3; then K2 against its plain version, as
             in 4, at every (m, B, dtype, sweeps) the two runs launched it
             with;
8. timing    K1 (live-lane pre-pass included) against its plain version
             at both path shapes, the zT chain and the QFT n=28 readout
             chain of phase 7, in turns, with the kernel alone on the
             packed chain, the pre-pass's own time, the live share
             (sum w_s w_{s+1} / n chi^2), the bound (8 B sum w_s w_{s+1}
             flops, the live cores' bytes) and the padded work's time at
             the fp32 peak (8 B n chi^2 flops: the bound of a kernel that
             multiplies all of chi, as K1 did before its pre-pass); K2
             against its plain version and torch.linalg.eigh at the QFT
             path's shapes, CUDA events, in turns, with K2's time per
             Jacobi round (and, after the gate phases, at the gate path's
             shapes: every shape on the cluster variant, 84 < m <= 320,
             that the gate phases launched, plus c64 m = 288 B = 1 at 7
             sweeps and f32 m = 160 at 6: the "device_memory" records of
             K2's line);
9. trace     torch.profiler (device activity only: recording the host's
             ops too doubles the build's wall time under the profiler and
             takes minutes to process) over one n=28 QFT
             build and one apply after the timed runs: K2's summed device
             time and launches, all kernels' device time, the stage's wall
             time under the profiler and the card's busy share (the union
             of device activity over that wall time).

10. gate pole the reference tutorial's pole search on the gate path:
             x_j = e^{-1.6e-4 j} sin(4.08e-3 j), n=20, TT-SVD encode on the
             card (cutoff 1e-12, maxdim 128), ZTPipeline(20, chi=128,
             build_cutoff=1e-9, engine="gate", readout="apply")
             .find_poles(128, 128, 24): two gate builds (wr = 2 pi, 0.5),
             the zip-up apply, K1 reads of the chi-128 product states; the
             pole within max(5e-4, 4 * 8 * 2 pi / N) of e^{-lam +- i w};
             the search's wall time, K1 and K2 launches (and those of
             each gate build and encode by (m, B, dtype, sweeps): each
             eigensolve of a factor fold one launch for its three stacks,
             B = 3; of a ZTMPS fan-out split, one for its n sites); then
             its two transforms replayed through zt_mpo(engine="gate") and
             apply, each timed, and K1 against its plain version in
             complex128 at
             each scan's configs (B = 16384, 16641, 2401) on the replayed
             product states, whose K1 reads must be the search's own;
11. DT       DTPipeline(20, 2 pi, chi=64, build_cutoff=1e-9) on the
             sin_decay signal, 4096 (k, j) read against
             x_j e^{-wr k j / N} / sqrt(N); bar 0.1 (a broken path);
12. gate n=30 the reference's published zT runtime configuration once:
             sin_decay materialized (2^30 float32 on the card), rsvd encode
             (k=50, p=5, q=2, cutoff 1e-9, maxdim 128), build_zt_mpo(30,
             2 pi, cutoff=1e-9, chi=128) in complex64 as its two steps,
             each timed (the factor folds, one batched program for the
             three stacks, then the fuse), each step's K2 launches by
             (m, B, dtype, sweeps) logged, the zip-up apply and a
             chi_grid read of the 64 x 64 grid of the first 64 near-peak k
             and l of scan_samples(30) (B = 4096), scored against the
             oracle (logged, not gated); K1 against its plain version in
             complex128 on that chi-128 product chain; then the n=20
             build's batched fold (wr = 2 pi) against each of its three
             stacks folded alone: the same bonds, cores within 1e-5 of
             the largest entry (bit-identity logged), K2 launches of one
             stack at B = 3, each slot of K2 at those shapes equal to its
             matrix alone, both folds timed; then K2 against its plain
             version, as in 4, at every (m, B, dtype, sweeps) the
             gate phases launched it with that no earlier path did, K1
             timed on the product chain as in 8, K2 timed at the gate
             phases' three most launched new shapes and at the shapes of
             the cluster variant (see 8);
13. trace    one n=20 gate build under torch.profiler, as in 9, with its
             K2 launches by call and shape.

14. batch    the batched QFT path (qilaplace_tpu_torch.parallel):
             batched_qft_pipeline over 8 signals x_j = sin(a_b j),
             a_b = (b + 1) / N, at n=28 (8 x 1 GiB float32, made on the
             card), through shard_batch on a mesh of this card, W =
             build_qft_mpo(28, chi=64, cutoff=1e-9) in complex64
             replicated, chi 64, cutoff 1e-9, phase 7's 4096 frequencies;
             each row against its closed form (bar 0.1) and against the
             one-signal path coefficient_batch(apply(W, signal_mps(x_b)))
             on the card (relative to the peak, bar 1e-3); K2's launches
             over the batch must equal those over one signal, each with
             B = 8; wall time of the batch (before and after the loop)
             against the 8 one-signal runs, max_memory_allocated; then K2
             against its plain version, as in 4, at every shape the batch
             launched, and K2's cluster variant at m = 128 with a
             different matrix in each of 8 slots (c64 and f32): eigenvalues
             bit-identical to the plain version, each slot equal to its
             matrix launched alone;
15. multi    the reference runner's multi-operator scan
             (scripts/benchmark/batched_scan.py): n=30 cross encode at
             1e-12 / maxdim 128 then tighten, 8 analytic operators at
             wr = 2 pi (1 + i / 8) (zt_product_pack, mpo_from_pack,
             complex64), stack_mpos, scan_configs(30, 4096);
             multi_mpo_chi_batch against the 8 apply_coefficient_batch
             calls (relative to the peak, bar 1e-5) and sharded_multi_scan
             on a mesh of this card equal to it; one scan against the
             stacked scan, CUDA events, median of 3;
16. entries  qilaplace_tpu_torch.entry: entry() built and its step run
             once (256 finite float32 values), then
             dryrun_multichip(torch.cuda.device_count()) (the fit step
             descends, the grid-sharded readout, the n=10 multi-operator
             scan's peaks on the signal's line).

K2 is timed (as in 8) at every shape the batched phase launched, beside
its plain version and the batched torch.linalg.eigh ("batched_shapes" in
K2's line).

17. tutorials the four tutorials of qilaplace_tpu_torch.tutorials (signal,
             dft, dt, zt: the JAX package's docs/tutorials at their own
             sizes, n = 2 to 14) through run(device=card,
             dtype=complex64), each timed on the host clock, synchronised;
             each asserts its tutorial's facts at its complex64 bars and
             writes no file; each must launch K2 with no plain Jacobi call
             on the card, and zt must launch K1; the K2 launches of each
             of its builds and encodes are logged by shape; every K1
             launch of a tutorial (recorded by a hook that counts nothing)
             is held against K1's plain version in complex128 on its own
             chain and configs; then K2 against its plain version, as in
             4, at every shape they launched that no earlier phase did.
             Then K2's group variant (m > 320) timed as in 8 (one plain
             call and 10 kernel calls a turn): c64 m = 384
             at 11 sweeps, c64 m = 512 at 6, 7 and 11, f32 m = 512 at 7,
             and every shape of it any phase launched, with the launches
             of every phase ("group" in K2's line).

Every gate, batched and entry phase sets the counts to 0 just before it,
reads them just after and fails if the plain Jacobi solver ran on the
card.

Every failure raises. Without a CUDA device the script exits nonzero at
once. The last line of stdout is one JSON object naming the device.

Run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

N_BITS = 30
N_SCAN = 4096
WR = 2 * math.pi
FREQ, DECAY = 2.0, 0.5
CHI = 128
CUTOFF = 1e-12
K1_TOL = 1e-5        # max |kernel - plain(c128)| / max |plain(c128)|
ACC_BAR = 1e-5       # max_err_rel_peak bar for both signal families
MPO_BOND = 57        # the zT operator's bond at n=30, cutoff 1e-12
QFT_BITS = 28        # the reference's published QFT size ("n=28 :sin")
QFT_CHI, QFT_CUTOFF = 64, 1e-9
QFT_ENCODE = dict(method="rsvd", k=50, p=5, q=2)
QFT_BARS = {28: 0.1, 16: 8e-3}  # max_err_rel_peak bars (see the docstring)
GATE_CUTOFF = 1e-9  # the reference's zt_full_runtime cutoff: range-mode zips
POLE_BITS = 20       # the reference tutorial's flagship pole search
FOLD_SLOT_TOL = 1e-5  # a batched fold's slot vs its stack alone, rel to peak
POLE_LAM, POLE_W = 1.6e-4, 4.08e-3  # its signal e^{-lam j} sin(w j)
DT_BITS, DT_CHI, DT_BAR = 20, 64, 0.1
GRID = 64            # the n=30 gate read: a GRID x GRID chi_grid
# K2's cluster variant off the gate path at cutoff 1e-9: the largest
# complex64 solve below cutoff 1e-10 and the real variant, (m, B, complex,
# sweeps)
CLUSTER_SHAPES = ((288, 1, True, 7), (160, 1, False, 6))
# K2's group variant (m > 320) off every path but the tutorials: its real
# variant
GROUP_SHAPES = ((512, 1, False, 7),)
# K2 on the QFT path (m, B, complex, sweeps): the build's two-site polish
# (first: the "kernels" line's K2 record) and the sketch and encode solves
QFT_K2_SHAPES = [(24, 1, True, 5), (40, 1, True, 6), (80, 1, True, 6),
                 (56, 8, False, 6)]
ROUTE_BITS = 8       # the readout-routes phase
BATCH = 8            # the batched QFT phase: signals in one batch
BATCH_BAR = 1e-3     # batched rows vs the one-signal path, rel to the peak
N_OPS = 8            # the multi-operator scan: stacked operators
MULTI_BAR = 1e-5     # stacked scan vs single scans, rel to the peak
PEAK_FP32 = 67e12    # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM bytes/s
K2_PRIMITIVES = Path(__file__).resolve().parent / "scripts" / "port" / \
    "k2_primitives.cu"
GROUP_THREADS = 736  # a block of K2's group variant at m = 512 (row_pairs)


def log(*args):
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


# ------------------------------ workload ------------------------------------

def port_helpers():
    """tests/port/port_helpers.py (no JAX): the random and ragged chains
    that the K1 GPU tests use too."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests" / "port"))
    import port_helpers as ph

    return ph


def scan_samples(n):
    """bench.py's 4096 (k, l) scan points: half near the peak (where the
    oracle comparison is meaningful), half uniform over the grid."""
    N = 2**n
    rng = np.random.default_rng(0)
    h = N_SCAN // 2
    ks = np.concatenate([rng.integers(0, min(256, N), h),
                         rng.integers(0, N, h)])
    ls = np.concatenate([rng.integers(0, min(8192, N), h) % N,
                         rng.integers(0, N, h)])
    kb = ((ks[:, None] >> np.arange(n)) & 1).astype(np.int32)  # LSB-first
    lb = ((ls[:, None] >> np.arange(n)) & 1).astype(np.int32)
    cfg = np.stack([kb, lb], axis=2).reshape(N_SCAN, 2 * n)
    return ks, ls, cfg


def sin_decay_fn(n):
    """x_j = sin(w j) e^{-lam j}, w = freq dt, lam = decay dt,
    dt = 1 / (freq 2^n), as a callable the cross encoder samples."""
    dt = 1.0 / (FREQ * 2**n)
    w, lam = FREQ * dt, DECAY * dt

    def f(j):
        j = j.astype(np.float64)
        return np.sin(w * j) * np.exp(-lam * j)

    f.n_bits = n
    return f


def multi_sin_exp_fn(n):
    """bench.py's second family: 10 seeded damped sinusoids."""
    dt = 1.0 / (2 * np.pi * 2**n)
    n_terms = 10
    ak = np.random.default_rng(1001).random(n_terms)
    ak = ak / np.linalg.norm(ak)
    wk = (40.0 * dt) * (np.random.default_rng(2002).random(n_terms) - 0.5)
    lk = (2.0 * dt) * np.random.default_rng(4004).random(n_terms)

    def f(j):
        j = j.astype(np.float64)
        out = np.zeros_like(j)
        for a, w, lam in zip(ak, wk, lk):
            out += a * np.sin(w * j) * np.exp(-lam * j)
        return out

    f.n_bits = n
    f.oracle_params = dict(ws=wk, lams=lk, phs=np.zeros(n_terms), amps=ak)
    return f


def accuracy(n, got, ks, ls, oracle_params=None):
    """bench.py's max |got - oracle| / peak |oracle| over the near-peak
    half of the scan; ``got`` is the raw readout (signal norm included)."""
    from qilaplace_tpu_torch.signals.oracles import (
        damped_sin_norm,
        damped_sin_zt_oracle,
        sin_decay_norm,
        sin_decay_zt_oracle,
    )

    h = N_SCAN // 2
    if oracle_params is None:
        want = sin_decay_zt_oracle(n, ks[:h], ls[:h], wr=WR, freq=FREQ,
                                   decay_rate=DECAY)
        nrm = sin_decay_norm(n, freq=FREQ, decay_rate=DECAY)
    else:
        want = damped_sin_zt_oracle(n, ks[:h], ls[:h], wr=WR,
                                    **oracle_params)
        nrm = damped_sin_norm(n, **oracle_params)
    got = got[:h].astype(np.complex128) / nrm
    return float(np.abs(got - want).max() / np.abs(want).max())


def synced(fn):
    """fn() and its wall seconds, bracketed by device synchronisation."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps=10):
    """Mean milliseconds per call of fn over ``reps`` calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ------------------------------ phases --------------------------------------

def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(smi)
    return smi


def phase_build():
    from qilaplace_tpu_torch.ops.kernel_build import build_kernels
    from qilaplace_tpu_torch.ops.jacobi_kernels import SOURCE as K2_SOURCE
    from qilaplace_tpu_torch.ops.readout_kernels import SOURCE as K1_SOURCE

    t0 = time.perf_counter()
    # one nvcc each, in parallel
    infos = build_kernels(K1_SOURCE, K2_SOURCE, str(K2_PRIMITIVES))
    log(f"[build] K1, K2 and K2's primitives ready in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, info in infos.items():
        log(f"[build] {name} {'reused' if info['cached'] else 'built'} in "
            f"{info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {line.strip()}")


def phase_k2_primitives(smi, iters=2000):
    """K2's exchange primitives alone (scripts/port/k2_primitives.cu,
    cooperative launches of GROUP_THREADS threads a block, CUDA events,
    median of 3): a flag round trip through L2 between two blocks, and the
    group variant's round without its arithmetic across nb = 16, 24, 32
    blocks (a fenced flag a block, one warp waiting for all; or one
    counter), with no columns and with the four columns of m = 512 it
    sends a neighbour. Returns microseconds by name."""
    import ctypes

    from qilaplace_tpu_torch.ops.kernel_build import load_kernel

    loop = load_kernel(str(K2_PRIMITIVES)).qlt_l2_loop
    loop.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    loop.restype = ctypes.c_int
    flags = torch.zeros(32, dtype=torch.int32, device="cuda")
    words = 4 * 512  # float2: four columns of m = 512
    boxes = torch.zeros(2 * 32 * words * 2, dtype=torch.float32, device="cuda")
    sink = torch.zeros(1, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cases = [("flag round trip, 2 blocks", 0, 2, 0)]
    cases += [(f"{what} barrier, {nb} blocks, {n} words", mode, nb, n)
              for mode, what in ((1, "flag"), (2, "counter"))
              for nb in (16, 24, 32) for n in (0, words)]
    out = {}
    for name, mode, nb, n in cases:
        def run():
            err = loop(mode, nb, GROUP_THREADS, iters, n, flags.data_ptr(),
                       boxes.data_ptr(), sink.data_ptr(), stream)
            check(err == 0, f"K2 primitive {name}: CUDA error {err}")
        run()
        torch.cuda.synchronize()
        us = 1e3 * float(np.median([event_ms(run, reps=1)
                                    for _ in range(3)])) / iters
        out[name] = us
        log(f"[prim] K2 {name}: {us:.4f} us an iteration ({iters} "
            f"iterations); card {smi}")
    return out


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of the operations at the card's
    fp32 peak and the bytes at its memory rate."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def k1_vs_plain(chain, cfg):
    """(max abs err, max abs err / max |ref|) of K1 against the plain
    version run in complex128 on the same inputs."""
    from qilaplace_tpu_torch.ops.readout_kernels import coefficient_batch_k1

    return k1_err(coefficient_batch_k1(chain, cfg), chain, cfg)


def k1_err(got, chain, cfg):
    """(max abs err, max abs err / max |ref|) of K1's output ``got`` on
    ``chain`` at ``cfg`` against the plain version run in complex128."""
    from qilaplace_tpu_torch.ops.readout_kernels import (
        coefficient_batch_k1_reference,
    )

    torch.cuda.synchronize()
    check(got.shape == (cfg.shape[0],), "K1 output shape")
    check(bool(torch.isfinite(torch.view_as_real(got)).all()),
          "K1 output not finite")
    ref = coefficient_batch_k1_reference(chain.to(dtype=torch.complex128), cfg)
    torch.cuda.synchronize()
    err = float((got.to(torch.complex128) - ref).abs().max())
    return err, err / float(ref.abs().max())


def phase_k1_check(dev, cfg_main):
    from qilaplace_tpu_torch.ops.readout_kernels import coefficient_batch_k1

    ph = port_helpers()
    rng = np.random.default_rng(2024)

    def bits(B, n):
        return torch.from_numpy(
            rng.integers(0, 2, (B, n)).astype(np.int32)).to(dev)

    cases = [("main-path shape", ph.random_chain(rng, 2 * N_BITS, 256, dev),
              cfg_main),
             ("chi=8 n=5 B=5", ph.random_chain(rng, 5, 8, dev), bits(5, 5)),
             ("chi=32 n=20 B=1000", ph.random_chain(rng, 20, 32, dev),
              bits(1000, 20))]
    for n, chi, ranks, dead in ph.RAGGED.values():
        chain = ph.ragged_chain(rng, n, chi, ranks, dead, dev)
        for B in (1, 33, 4097):
            cases.append((f"ragged chi={chi} n={n} B={B}", chain, bits(B, n)))
        for bit in (0, 1):
            cases.append((f"ragged chi={chi} n={n} B=100 all bits {bit}",
                          chain, torch.full((100, n), bit, dtype=torch.int32,
                                            device=dev)))
    for name, chain, cfg in cases:
        err, rel = k1_vs_plain(chain, cfg)
        log(f"[k1] {name}: max_abs_err {err:.3e} rel {rel:.3e} "
            f"(tol {K1_TOL:g})")
        check(rel <= K1_TOL, f"K1 disagrees with its plain version ({name})")
    # extra dead lanes change nothing the kernel computes
    chain = ph.ragged_chain(rng, 10, 128, [1, 4, 16, 60, 128, 100, 128, 77,
                                           30, 4, 1], {5: 64}, dev)
    cfg = bits(999, 10)
    same = torch.equal(coefficient_batch_k1(chain, cfg),
                       coefficient_batch_k1(ph.embed(chain, 256, rng), cfg))
    log(f"[k1] chi=128 chain inside chi 256 (extra dead lanes): "
        f"bit-identical {same}")
    check(same, "K1 changed with extra dead lanes")


def zt_operands(dev):
    """The bench's n=30 sin_decay operands on the card: (W, psi) and the
    seconds of the encode, the build and the ship."""
    import qilaplace_tpu_torch as qt

    t0 = time.perf_counter()
    psi = qt.tighten(qt.signal_ztmps_cross(
        sin_decay_fn(N_BITS), cutoff=CUTOFF, maxdim=CHI, device="cpu"))
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    pack = qt.zt_product_pack(N_BITS, WR, cutoff=CUTOFF, maxdim=CHI)
    t_build = time.perf_counter() - t0

    def ship():
        W = qt.tighten(qt.mpo_from_pack(pack, device=dev,
                                        dtype=torch.complex64))
        return W, psi.to(dev, torch.float32)

    (W, psi_d), t_ship = synced(ship)
    return W, psi_d, (t_enc, t_build, t_ship)


def phase_main_path(dev, ks, ls, configs):
    import qilaplace_tpu_torch as qt

    def scan(W, psi_d):
        return synced(lambda: qt.direct_vals(W, psi_d, configs))

    W, psi_d, _ = zt_operands(dev)
    scan(W, psi_d)  # warm-up
    runs = []
    for _ in range(3):
        W, psi_d, parts = zt_operands(dev)
        vals, t_scan = scan(W, psi_d)
        runs.append((sum(parts) + t_scan, parts, t_scan, vals))
    total, (t_enc, t_build, t_ship), t_scan, vals = sorted(
        runs, key=lambda r: r[0])[1]
    check(vals.shape == (N_SCAN,), "readout shape")
    check(bool(torch.isfinite(torch.view_as_real(vals)).all()),
          "readout not finite")
    err = accuracy(N_BITS, vals.cpu().numpy(), ks, ls)
    mpo_bond = qt.max_bond(W)
    chi_eff = W.chain.chi * psi_d.chain.chi
    log(f"[main] sin_decay n={N_BITS}: value {total:.4f} s = encode_s "
        f"{t_enc:.4f} + build_s {t_build:.4f} + ship_s {t_ship:.4f} + "
        f"scan_s {t_scan:.4f}")
    log(f"[main] max_err_rel_peak {err:.3e} mpo_bond {mpo_bond} "
        f"psi rank {qt.max_bond(psi_d)} chi_eff {chi_eff} "
        f"({'K1' if chi_eff <= 256 else 'factored'})")

    f2 = multi_sin_exp_fn(N_BITS)
    psi2 = qt.tighten(qt.signal_ztmps_cross(f2, cutoff=CUTOFF, maxdim=CHI,
                                            device="cpu"))
    psi2 = psi2.to(dev, torch.float32)
    vals2, t_scan2 = scan(W, psi2)
    check(bool(torch.isfinite(torch.view_as_real(vals2)).all()),
          "multi_sin_exp readout not finite")
    err2 = accuracy(N_BITS, vals2.cpu().numpy(), ks, ls, f2.oracle_params)
    chi_eff2 = W.chain.chi * psi2.chain.chi
    log(f"[main] multi_sin_exp: max_err_rel_peak {err2:.3e} psi rank "
        f"{qt.max_bond(psi2)} chi_eff {chi_eff2} "
        f"({'K1' if chi_eff2 <= 256 else 'factored'}) scan_s {t_scan2:.4f}")

    check(err <= ACC_BAR, f"sin_decay max_err_rel_peak {err:.3e}")
    check(err2 <= ACC_BAR, f"multi_sin_exp max_err_rel_peak {err2:.3e}")
    check(mpo_bond == MPO_BOND, f"mpo_bond {mpo_bond} != {MPO_BOND}")
    return qt.zipper_chain(W, psi_d)


def phase_pole(dev):
    import qilaplace_tpu_torch as qt

    N = 2**N_BITS
    dt = 1.0 / (FREQ * N)
    w, lam = FREQ * dt, DECAY * dt
    with tempfile.TemporaryDirectory() as cache_dir:
        pipe = qt.ZTPipeline(N_BITS, cache_dir=cache_dir, device=dev)
        psi = pipe.encode(sin_decay_fn(N_BITS)).to(dtype=torch.float32)
        res, secs = synced(lambda: pipe.find_poles(
            psi, coarse_points=64, fine_points=64, superfine_half=8,
            readout="direct"))
    z = complex(res.z_pole)
    poles = [complex(math.exp(-lam) * complex(math.cos(w), s * math.sin(w)))
             for s in (1, -1)]
    dist = min(abs(z - p) for p in poles)
    bar = 64 * 2 * math.pi / N
    log(f"[pole] peak (k, l) = ({int(res.superfine.k_peak)}, "
        f"{int(res.superfine.l_peak)}), z_pole {z!r}, distance to the pole "
        f"{dist:.3e} (bar {bar:.3e}), search {secs:.3f} s")
    check(dist < bar, "pole search missed the pole")


def phase_timing(chain, cfg, smi, shape):
    """K1 against its plain complex64 version on one path chain, in turns,
    with the live-lane pre-pass alone and the kernel alone on the packed
    chain beside them; returns the record of the ``kernels`` line."""
    from qilaplace_tpu_torch.ops import readout_kernels as rk

    err, rel = k1_vs_plain(chain, cfg)
    check(rel <= K1_TOL, f"K1 disagrees with its plain version ({shape})")
    B, n, chi = cfg.shape[0], chain.n, chain.chi
    packed, widths = rk.pack_live_lanes(chain.cores)
    amp = chain.amplitude.to(device=cfg.device,
                             dtype=torch.float32).reshape(1)
    out = torch.empty(B, dtype=torch.complex64, device=cfg.device)
    stream = torch.cuda.current_stream().cuda_stream
    fns = {"kernel": lambda: rk.coefficient_batch_k1(chain, cfg),
           "plain": lambda: rk.coefficient_batch_k1_reference(chain, cfg),
           "prepass": lambda: rk.pack_live_lanes(chain.cores),
           "alone": lambda: rk._kernel()(
               packed.data_ptr(), widths.data_ptr(), cfg.data_ptr(),
               amp.data_ptr(), out.data_ptr(), B, n, packed.shape[1], stream)}
    for f in fns.values():
        f()  # warm-up
    check(fns["alone"]() == 0, f"K1 alone failed to launch ({shape})")
    ms = {k: [] for k in fns}
    for _ in range(3):  # in turns: plain, kernel, ..., then reversed
        for k in ("plain", "kernel", "prepass", "alone", "alone", "prepass",
                  "kernel", "plain"):
            ms[k].append(event_ms(fns[k]))
    med = {k: float(np.median(v)) for k, v in ms.items()}
    w = widths.double().cpu()
    live = float((w[:-1] * w[1:]).sum())
    io_bytes = cfg.numel() * 4 + B * 8
    # one complex MAC (8 flops) per (row, k, j) of the selected branch
    pad_ms, _ = bound(8.0 * B * n * chi**2,
                      chain.cores.numel() * 8 + io_bytes)
    live_ms, live_by = bound(8.0 * B * live, 2 * live * 8 + io_bytes)
    log(f"[time] K1 on the {shape} (n {n}, chi {chi}, B {B}): kernel "
        f"{med['kernel']:.4f} ms with the pre-pass ({med['prepass']:.4f} ms "
        f"the pre-pass alone, {med['alone']:.4f} ms the kernel alone), plain "
        f"c64 {med['plain']:.4f} ms; live share {live / (n * chi**2):.4f}; "
        f"bound {live_ms:.4f} ms ({live_by}): {live_ms / med['kernel']:.1%} "
        f"of it with the pre-pass, {live_ms / med['alone']:.1%} alone; the "
        f"padded work at the fp32 peak {pad_ms:.4f} ms; max_abs_err "
        f"{err:.3e} rel {rel:.3e}; card {smi}")
    check(med["kernel"] < med["plain"],
          f"K1 slower than its plain version ({shape})")
    return dict(max_abs_err=err, ms=med["kernel"], plain_ms=med["plain"],
                bound_ms=live_ms, bound_by=live_by, alone_ms=med["alone"],
                prepass_ms=med["prepass"], padded_work_ms=pad_ms,
                live_share=live / (n * chi**2))


# ------------------------------ kernel K2 -----------------------------------

def hermitian(rng, B, m, complex_=True, spectrum=None, rank=None):
    """[B, m, m] Hermitian test matrices made with numpy: Gaussian, or
    U diag(spectrum) U^H, or the Gram matrix of a rank-``rank`` block
    zero-padded to m."""
    def gauss(*s):
        return rng.normal(size=s) + (1j * rng.normal(size=s) if complex_
                                     else 0)

    if spectrum is not None:
        U, _ = np.linalg.qr(gauss(B, m, m))
        H = (U * np.asarray(spectrum)) @ np.conj(np.swapaxes(U, -1, -2))
    elif rank is not None:
        H = np.zeros((B, m, m), dtype=complex)
        X = gauss(B, m // 2, rank)
        H[:, : m // 2, : m // 2] = X @ np.conj(np.swapaxes(X, -1, -2))
    else:
        A = gauss(B, m, m)
        H = (A + np.conj(np.swapaxes(A, -1, -2))) / 2
    return H.astype(np.complex64 if complex_ else np.float32)


def k2_case(name, H, sweeps):
    """K2 against its plain version (same sweeps, same dtype, on the card):
    eigenvalues within jacobi_kernels.tolerance, the other figures within
    jacobi_kernels.rounding_bar of the plain version's own. Logs both and
    returns the eigenvalues' max abs error."""
    from qilaplace_tpu_torch.ops import jacobi_kernels as jk

    m = H.shape[-1]
    lam, V = jk.jacobi_eigh_k2(H, sweeps=sweeps)
    torch.cuda.synchronize()
    lam_p, V_p = jk.jacobi_eigh_k2_reference(H, sweeps=sweeps)
    scale = float(lam_p.abs().max().clamp_min(1e-30))
    abs_err = float((lam - lam_p).abs().max())
    tol = jk.tolerance(m)
    got, plain = jk.figures(H, lam, V), jk.figures(H, lam_p, V_p)
    same = (float((lam == lam_p).double().mean()),
            float((V == V_p).double().mean()))
    log(f"[k2] {name}: lam {abs_err / scale:.2e} (tol {tol:.0e}); "
        + "; ".join(f"{k} {v:.2e} plain {plain[k]:.2e} (bar "
                    f"{jk.rounding_bar(m, plain[k]):.1e})"
                    for k, v in got.items())
        + f"; bit-identical to plain: lam {same[0]:.1%}, V {same[1]:.1%}")
    check(abs_err / scale <= tol,
          f"K2 lam {abs_err / scale:.2e} > {tol:.0e} ({name})")
    for k, v in got.items():
        bar = jk.rounding_bar(m, plain[k])
        check(v <= bar, f"K2 {k} {v:.2e} > {bar:.1e} ({name})")
    return abs_err


def phase_k2_check(dev):
    from qilaplace_tpu_torch.ops.jacobi import default_sweeps, fast_sweeps
    from qilaplace_tpu_torch.ops.jacobi_kernels import (
        CLUSTER_MAX_M,
        SMEM_MAX_M,
    )

    rng = np.random.default_rng(2026)
    cases = [(f"c64 m={m} B=1 sweeps={sw}", hermitian(rng, 1, m), sw)
             for m, sw in ((24, 5), (40, 6), (80, 4), (80, 6))]
    cases += [(f"f32 m=56 B={B} sweeps={fast_sweeps(56)}",
               hermitian(rng, B, 56, complex_=False), fast_sweeps(56))
              for B in (1, 8)]
    cases += [(f"c64 m={m} B=4 default sweeps", hermitian(rng, 4, m),
               default_sweeps(m))
              for m in (2, SMEM_MAX_M, SMEM_MAX_M + 2, 256, CLUSTER_MAX_M,
                        CLUSTER_MAX_M + 2, 384, 448, 512)]
    cases += [(f"{'c64' if cplx else 'f32'} m={m} B={B} sweeps={sw}",
               hermitian(rng, B, m, complex_=cplx), sw)
              for m, B, cplx, sw in CLUSTER_SHAPES + GROUP_SHAPES]
    # clusters converge more slowly: at default sweeps the plain version's
    # own residual stays above 1e-5 (logged beside the kernel's), at 12 both
    # are converged
    clustered = hermitian(rng, 2, 24, spectrum=np.repeat(
        [-2.0, 0.5, 0.5000001, 3.0], 6))
    cases += [(f"c64 m=24 B=2 clustered spectrum, {sw} sweeps", clustered, sw)
              for sw in (default_sweeps(24), 12)]
    cases.append(("c64 m=24 B=2 zero-padded rank 3, default sweeps",
                  hermitian(rng, 2, 24, rank=3), default_sweeps(24)))
    return max(k2_case(name, torch.from_numpy(H).to(dev), sweeps)
               for name, H, sweeps in cases)


def phase_k2_cluster_stress(dev, repeats=3):
    """K2's cluster and group variants with more clusters or groups than
    the card holds at once (c64, 7 sweeps: B = 132 at m = 160 and 288, 8
    blocks a matrix; B = 11 at m = 384 and B = 9 at m = 512, 24 and 32
    blocks a matrix, 5 and 4 groups resident), launched ``repeats`` times:
    every run's eigenvalues must equal the plain version's bit for bit, and
    every run's V the first run's. A maker that read a column across a
    block edge before its store landed, or a group block that read a
    rotation or a column before its writer published it, would show as a
    run that differs. Returns the eigenvalues' max abs error (0)."""
    from qilaplace_tpu_torch.ops import jacobi_kernels as jk

    rng = np.random.default_rng(2028)
    worst = 0.0
    for m, B in ((160, 132), (288, 132), (384, 11), (512, 9)):
        H = torch.from_numpy(hermitian(rng, B, m)).to(dev)
        lam_p, _ = jk.jacobi_eigh_k2_reference(H, sweeps=7)
        V0 = None
        for run in range(repeats):
            lam, V = jk.jacobi_eigh_k2(H, sweeps=7)
            torch.cuda.synchronize()
            V0 = V if V0 is None else V0
            same = float((lam == lam_p).double().mean())
            worst = max(worst, float((lam - lam_p).abs().max()))
            log(f"[k2] stress c64 m={m} B={B} sweeps=7, run {run}: lam "
                f"bit-identical to plain {same:.1%}, V equal to run 0: "
                f"{bool(torch.equal(V, V0))}")
            check(same == 1.0, f"K2 stress m={m} run {run}: eigenvalues "
                  "differ from the plain version")
            check(torch.equal(V, V0), f"K2 stress m={m} run {run}: V differs "
                  "from run 0")
    return worst


def phase_k2_batch_slots(dev):
    """K2's cluster variant with a different matrix in each of BATCH slots
    (m = 128, c64 at 6 sweeps and f32 at 4): eigenvalues against the plain
    version as in 4 (bit-identical, gated), and every slot equal to its
    matrix launched alone. Returns the eigenvalues' max abs error."""
    from qilaplace_tpu_torch.ops import jacobi_kernels as jk

    rng = np.random.default_rng(2029)
    worst = 0.0
    for cplx, sweeps in ((True, 6), (False, 4)):
        H = torch.from_numpy(hermitian(rng, BATCH, 128, complex_=cplx)).to(dev)
        name = f"{'c64' if cplx else 'f32'} m=128 B={BATCH} sweeps={sweeps}"
        worst = max(worst, k2_case(f"{name}, distinct slots", H, sweeps))
        lam, V = jk.jacobi_eigh_k2(H, sweeps=sweeps)
        lam_p, _ = jk.jacobi_eigh_k2_reference(H, sweeps=sweeps)
        alone = [jk.jacobi_eigh_k2(H[b:b + 1], sweeps=sweeps)
                 for b in range(BATCH)]
        torch.cuda.synchronize()
        same = all(torch.equal(lam[b], a[0][0]) and torch.equal(V[b], a[1][0])
                   for b, a in enumerate(alone))
        log(f"[k2] {name}: every slot equal to its matrix alone: {same}; "
            f"eigenvalues bit-identical to plain: "
            f"{bool(torch.equal(lam, lam_p))}")
        check(same, f"K2 {name}: a slot differs from its matrix alone")
        check(torch.equal(lam, lam_p),
              f"K2 {name}: eigenvalues differ from the plain version")
    return worst


def phase_k2_path_shapes(dev, shapes):
    """K2 against its plain version at every (m, B, dtype, sweeps) the QFT
    path launched it with."""
    rng = np.random.default_rng(2027)
    worst = 0.0
    for m, B, kind, sweeps in sorted(shapes):
        H = hermitian(rng, B, m, complex_=kind == "c64")
        worst = max(worst, k2_case(f"path {kind} m={m} B={B} sweeps={sweeps}",
                                   torch.from_numpy(H).to(dev), sweeps))
    return worst


def phase_readout_routes(dev):
    """A complex128 state through the four entry points that read it
    directly, and chi = 264 chains through QFTPipeline.spectrum, on the
    card against the same call on the CPU: none of them may launch K1
    (k1_takes: complex64 and chi <= 256 only)."""
    import qilaplace_tpu_torch as qt
    from qilaplace_tpu_torch.ops import readout_kernels as rk

    n = ROUTE_BITS
    rng = np.random.default_rng(8)
    ks = torch.from_numpy(rng.integers(0, 2**n, 12))
    ls = torch.from_numpy(rng.integers(0, 2**n, 10))
    psi = qt.tighten(qt.signal_ztmps_cross(sin_decay_fn(n), cutoff=CUTOFF,
                                           device="cpu"))  # float64
    pack = qt.zt_product_pack(n, WR, cutoff=CUTOFF, maxdim=CHI)

    def operator(device):
        return qt.tighten(qt.mpo_from_pack(pack, device=device,
                                           dtype=torch.complex128))

    def rel(got, want):
        got = got.cpu().to(torch.complex128)
        return float((got - want).abs().max() / want.abs().max())

    qft = qt.QFTPipeline(n, chi=16, cutoff=CUTOFF, dtype=torch.complex128,
                         device="cpu")
    qft_out = qft.forward(qft.encode(qt.generate_signal(
        n, dtype=torch.float64, device="cpu")))
    freqs = torch.arange(0, 2**n, 3)
    wide = port_helpers().random_chain(np.random.default_rng(264), n, 264,
                                       "cpu", amplitude=1.5)
    search = dict(coarse_points=32, fine_points=16, superfine_half=4,
                  readout="direct")
    with tempfile.TemporaryDirectory() as cache_dir:
        pipe = dict(chi=CHI, dtype=torch.complex128, cache_dir=cache_dir)
        calls = {
            "chi_grid_direct c128": lambda d: qt.chi_grid_direct(
                operator(d), psi.to(d), ks.to(d), ls.to(d)),
            "ZTPipeline.chi_grid_direct c128": lambda d: qt.ZTPipeline(
                n, device=d, **pipe).chi_grid_direct(
                    psi.to(d), ks.to(d), ls.to(d), wr=WR),
            "coarse_to_fine_pole_search(readout='direct') c128":
                lambda d: qt.coarse_to_fine_pole_search(
                    psi.to(d), cache_dir=cache_dir, **search).superfine.chi,
            "QFTPipeline.spectrum c128": lambda d: qft.spectrum(
                qft_out.to(d), freqs.to(d)),
            "QFTPipeline.spectrum c128 chi 264": lambda d: qft.spectrum(
                wide.to(d, torch.complex128), freqs.to(d)),
        }
        for name, call in calls.items():
            want = call("cpu")
            before = rk.coefficient_batch_k1.launches
            got, secs = synced(lambda: call(dev))
            err = rel(got, want)
            log(f"[routes] {name}: card vs CPU rel {err:.3e} (bar 1e-10), "
                f"{got.dtype} on {got.device}, K1 launches "
                f"{rk.coefficient_batch_k1.launches - before}, {secs:.3f} s")
            check(got.is_cuda and got.dtype == torch.complex128,
                  f"{name}: not a complex128 result on the card")
            check(rk.coefficient_batch_k1.launches == before,
                  f"{name}: launched K1")
            check(err <= 1e-10, f"{name}: card and CPU differ ({err:.3e})")
        want = qft.spectrum(wide.to(dtype=torch.complex128), freqs)
        before = rk.coefficient_batch_k1.launches
        got = qft.spectrum(wide.to(dev), freqs.to(dev))
        err = rel(got, want)
        log(f"[routes] QFTPipeline.spectrum c64 chi 264: card vs CPU c128 "
            f"rel {err:.3e} (bar {K1_TOL:g}), K1 launches "
            f"{rk.coefficient_batch_k1.launches - before}")
        check(rk.coefficient_batch_k1.launches == before,
              "spectrum of a chi 264 chain launched K1")
        check(err <= K1_TOL, f"spectrum c64 chi 264: {err:.3e}")


def phase_k2_timing(smi, shapes, plain_reps=3, reps=20):
    """K2 against its plain version and torch.linalg.eigh at each distinct
    (m, B, complex, sweeps) of ``shapes``, in turns, ``plain_reps`` calls of
    the plain version and ``reps`` of the others a turn; returns one record
    per shape."""
    from qilaplace_tpu_torch.ops.jacobi_kernels import (
        jacobi_eigh_k2,
        jacobi_eigh_k2_reference,
    )

    rng = np.random.default_rng(7)
    shapes = list(dict.fromkeys(shapes))
    out = []
    for m, B, cplx, sweeps in shapes:
        H = torch.from_numpy(hermitian(rng, B, m, complex_=cplx)).to("cuda")
        kernel = lambda: jacobi_eigh_k2(H, sweeps=sweeps)  # noqa: E731
        plain = lambda: jacobi_eigh_k2_reference(H, sweeps=sweeps)  # noqa: E731
        library = lambda: torch.linalg.eigh(H)  # noqa: E731
        kernel(), plain(), library()  # warm-up
        ms = {"kernel": [], "plain": [], "library": []}
        for _ in range(2):  # in turns: plain, kernel, kernel, plain
            ms["plain"].append(event_ms(plain, reps=plain_reps))
            ms["kernel"].append(event_ms(kernel, reps=reps))
            ms["kernel"].append(event_ms(kernel, reps=reps))
            ms["plain"].append(event_ms(plain, reps=plain_reps))
            ms["library"].append(event_ms(library, reps=reps))
        med = {k: float(np.median(v)) for k, v in ms.items()}
        rounds = sweeps * (m - 1)
        # a round: 2x2 blocks of G on both sides and V's column pairs,
        # 30 m^2 flops complex (9 m^2 real); each input read once, each
        # output written once
        flops = B * rounds * (30 if cplx else 9) * m * m
        elem = 8 if cplx else 4
        nbytes = B * (m * m * elem + m * 4 + m * m * elem)
        bound_ms, bound_by = bound(flops, nbytes)
        per_round = {k: 1e3 * v / rounds for k, v in med.items()}  # us
        rec = dict(shape=f"{'c64' if cplx else 'f32'} m={m} B={B} "
                   f"sweeps={sweeps}", key=(m, B, "c64" if cplx else "f32",
                                            sweeps),
                   ms=med["kernel"], us_a_round=per_round["kernel"],
                   plain_ms=med["plain"], library_ms=med["library"],
                   bound_ms=bound_ms, bound_by=bound_by)
        log(f"[time] K2 {rec['shape']} ({rounds} rounds): kernel "
            f"{rec['ms']:.4f} ms ({per_round['kernel']:.3f} us a round), "
            f"plain {rec['plain_ms']:.3f} ms ({per_round['plain']:.1f} us a "
            f"round), torch.linalg.eigh {rec['library_ms']:.4f} ms "
            f"({per_round['library']:.3f} us a round), bound {bound_ms:.2e} "
            f"ms ({bound_by}); card {smi}")
        out.append(rec)
    return out


# ------------------------------ QFT path ------------------------------------

def sin_spectrum(n, ks, c=1):
    """Unitary DFT X_k of x_j = sin(a j), a = c/N (c a whole number), in
    closed form (float64): N^-1/2 (G(a - 2 pi k/N) - G(-a - 2 pi k/N)) / 2i
    with G(t) = (1 - e^{i t N}) / (1 - e^{i t}). Since t N = +-c - 2 pi k,
    the numerators are 1 - e^{+-i c}; 1 - e^{i t} = -2i sin(t/2) e^{i t/2}
    keeps the small denominators accurate."""
    N = 2**n
    ks = np.asarray(ks, dtype=np.float64)

    def G(sign):
        t = sign * c / N - 2 * np.pi * (ks / N)
        den = -2j * np.sin(t / 2) * np.exp(1j * t / 2)
        return (1 - np.exp(1j * sign * c)) / den

    return (G(1.0) - G(-1.0)) / (2j * np.sqrt(N))


def qft_freqs(n):
    """4096 read frequencies: 2048 in [0, 256) u (N - 256, N), 2048 uniform
    over [0, N), from a seeded generator."""
    N = 2**n
    rng = np.random.default_rng(28)
    near = rng.integers(0, 511, 2048)
    near = np.where(near < 256, near, N - 511 + near)
    return np.concatenate([near, rng.integers(0, N, 2048)])


def phase_qft(dev, n, runs=3):
    """QFTPipeline(n) on the card: build, encode, apply, read, each stage
    timed; the median of ``runs`` after a warm-up (the faster of two).
    Returns the error, the
    launch counts of one run and the readout's chain and configs."""
    import qilaplace_tpu_torch as qt
    from qilaplace_tpu_torch.core.mps import MPS, _chain
    from qilaplace_tpu_torch.ops.jacobi import jacobi_eigh
    from qilaplace_tpu_torch.ops.jacobi_kernels import jacobi_eigh_k2
    from qilaplace_tpu_torch.ops.readout_kernels import (
        coefficient_batch_k1,
        coefficient_batch_k1_reference,
    )
    from qilaplace_tpu_torch.utils.bits import tensor_int_to_bits

    ks = qft_freqs(n)
    freqs = torch.from_numpy(ks).to(dev)
    x, t_signal = synced(lambda: qt.generate_signal(n, device=dev))

    def one_run():
        pipe, t_build = synced(lambda: qt.QFTPipeline(
            n, chi=QFT_CHI, cutoff=QFT_CUTOFF, device=dev))
        psi, t_enc = synced(lambda: pipe.encode(x, **QFT_ENCODE))
        out, t_apply = synced(lambda: pipe.forward(psi))
        got, t_read = synced(lambda: pipe.spectrum(out, freqs))
        stages = dict(encode_s=t_enc, build_s=t_build, apply_s=t_apply,
                      read_s=t_read)
        return stages, (pipe, psi, out, got)

    one_run()  # warm-up
    runs_out = []
    for i in range(runs):
        if i == 0:  # count the launches of one full run
            coefficient_batch_k1.launches = 0
            jacobi_eigh_k2.launches = 0
            jacobi_eigh_k2.by_shape.clear()
            jacobi_eigh.cuda_calls = 0
        stages, res = one_run()
        if i == 0:
            counts = dict(k1=coefficient_batch_k1.launches,
                          k2=jacobi_eigh_k2.launches,
                          k2_by_shape=dict(jacobi_eigh_k2.by_shape),
                          plain_cuda=jacobi_eigh.cuda_calls)
        runs_out.append((sum(stages.values()), stages, res))
    total, stages, (pipe, psi, out, got) = sorted(
        runs_out, key=lambda r: r[0])[(len(runs_out) - 1) // 2]
    check(got.shape == (len(ks),), "QFT readout shape")
    # the readout at the output state's own shape (chi 64, complex64)
    # against K1's plain version in complex128 on the same configs
    cfg = tensor_int_to_bits(freqs, n, order="lsb",
                             device=dev).to(torch.int32).contiguous()
    read_chain = MPS(cores=_chain(out).cores.contiguous(),
                     ranks=_chain(out).ranks, amplitude=_chain(out).amplitude)
    ref = coefficient_batch_k1_reference(
        read_chain.to(dtype=torch.complex128), cfg)
    k1_rel = float((got.to(torch.complex128) - ref).abs().max()
                   / ref.abs().max())
    log(f"[qft] n={n}: readout (K1, chi {_chain(out).chi}) vs plain c128: "
        f"rel {k1_rel:.3e} (tol {K1_TOL:g})")
    check(k1_rel <= K1_TOL, f"K1 disagrees with its plain version on the "
          f"QFT n={n} output state")
    got = got.cpu().numpy().astype(np.complex128)
    check(bool(np.isfinite(got).all()), "QFT readout not finite")
    want = sin_spectrum(n, ks)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    log(f"[qft] n={n}: total {total:.4f} s = encode_s "
        f"{stages['encode_s']:.4f} + build_s {stages['build_s']:.4f} + "
        f"apply_s {stages['apply_s']:.4f} + read_s {stages['read_s']:.4f} "
        f"(signal {t_signal:.4f} s, not counted)")
    log(f"[qft] n={n}: max_err_rel_peak {err:.3e} (bar {QFT_BARS[n]:g}); "
        f"ranks W {qt.max_bond(pipe.mpo)} psi {qt.max_bond(psi)} out "
        f"{qt.max_bond(out)}")
    by_shape = ", ".join(f"({kind} m={m}, B={B}, sweeps={sw}): {c}"
                         for (m, B, kind, sw), c in
                         sorted(counts["k2_by_shape"].items()))
    log(f"[qft] n={n}: launches K1 {counts['k1']} K2 {counts['k2']} "
        f"[{by_shape}]; plain Jacobi calls on the card "
        f"{counts['plain_cuda']}")
    check(counts["k2"] > 0, f"the QFT path n={n} never launched K2")
    check(counts["k1"] > 0, f"the QFT readout n={n} never launched K1")
    check(counts["plain_cuda"] == 0,
          f"the QFT path n={n} ran the plain Jacobi solver on the card")
    check(np.isfinite(err) and err <= QFT_BARS[n],
          f"QFT n={n} max_err_rel_peak {err:.3e} > {QFT_BARS[n]:g}")
    return err, counts, (read_chain, cfg)


# ------------------------------ gate path -----------------------------------

def reset_counts():
    """Every kernel and plain-solver count to 0."""
    from qilaplace_tpu_torch.ops.jacobi import jacobi_eigh
    from qilaplace_tpu_torch.ops.jacobi_kernels import jacobi_eigh_k2
    from qilaplace_tpu_torch.ops.readout_kernels import coefficient_batch_k1

    coefficient_batch_k1.launches = 0
    jacobi_eigh_k2.launches = 0
    jacobi_eigh_k2.by_shape.clear()
    jacobi_eigh.cuda_calls = 0


def read_counts():
    from qilaplace_tpu_torch.ops.jacobi import jacobi_eigh
    from qilaplace_tpu_torch.ops.jacobi_kernels import jacobi_eigh_k2
    from qilaplace_tpu_torch.ops.readout_kernels import coefficient_batch_k1

    return dict(k1=coefficient_batch_k1.launches, k2=jacobi_eigh_k2.launches,
                k2_by_shape=dict(jacobi_eigh_k2.by_shape),
                plain_cuda=jacobi_eigh.cuda_calls)


def log_counts(tag, counts):
    log(f"[{tag}] launches K1 {counts['k1']} K2 {counts['k2']} "
        f"[{fmt_shapes(counts['k2_by_shape'])}]; plain Jacobi calls on the "
        f"card {counts['plain_cuda']}")
    check(counts["plain_cuda"] == 0,
          f"{tag}: the plain Jacobi solver ran on the card")


def fmt_shapes(by_shape):
    """K2 launches by (dtype, m, B, sweeps), most launched first."""
    return ", ".join(f"({kind} m={m}, B={B}, sweeps={sw}): {c}"
                     for (m, B, kind, sw), c in sorted(
                         by_shape.items(), key=lambda kv: (-kv[1], kv[0])))


# the gate builds and encoders whose every call logs its own K2 launches
# in the gate and tutorial phases
LOGGED_CALLS = ("signal_ztmps", "signal_mps", "build_zt_mpo",
                "_build_factors_concurrent", "_fuse_factors", "build_dt_mpo",
                "build_paired_qft_mpo")


@contextlib.contextmanager
def k2_by_call(tag):
    """Within the block, every call of LOGGED_CALLS (wherever a module of
    the port holds it) logs the K2 launches it made, by (m, B, dtype,
    sweeps), as the difference of the wrapper's count over the call; a
    nested call logs its own line first. The counts themselves move only
    where the wrapper launches."""
    from qilaplace_tpu_torch.ops.jacobi_kernels import jacobi_eigh_k2

    def logged(name, fn):
        def call(*args, **kwargs):
            before = collections.Counter(jacobi_eigh_k2.by_shape)
            out = fn(*args, **kwargs)
            made = jacobi_eigh_k2.by_shape - before
            first = args[0] if args else None
            what = (f"n={first}" if isinstance(first, int) else
                    f"x {tuple(first.shape)}" if torch.is_tensor(first)
                    else "")
            log(f"[{tag}] {name}({what}): K2 {sum(made.values())} "
                f"[{fmt_shapes(made)}]")
            return out
        return call

    patched = []
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("qilaplace_tpu_torch")]
    for name in LOGGED_CALLS:
        real = {id(getattr(m, name)): getattr(m, name) for m in mods
                if callable(getattr(m, name, None))}
        for fn in real.values():
            wrapped = logged(name, fn)
            for m in mods:
                if getattr(m, name, None) is fn:
                    patched.append((m, name, fn))
                    setattr(m, name, wrapped)
    try:
        yield
    finally:
        for m, name, fn in patched:
            setattr(m, name, fn)


def grid_read(state, ks, ls):
    """(chain, configs): what chi_grid hands K1 for the ``ks`` x ``ls``
    grid of a product state."""
    from qilaplace_tpu_torch.core.mps import MPS
    from qilaplace_tpu_torch.utils.bits import paired_config_from_kl

    m = state.chain
    K, L = torch.meshgrid(ks, ls, indexing="ij")
    cfg = paired_config_from_kl(K.reshape(-1), L.reshape(-1), state.n)
    return (MPS(cores=m.cores.contiguous(), ranks=m.ranks,
                amplitude=m.amplitude), cfg.contiguous())


def check_k1_read(tag, state, scan):
    """K1 against its plain version (complex128) on ``state`` at the
    configs of the ScanResult ``scan``; the K1 read must also be the one
    the scan returned."""
    from qilaplace_tpu_torch.ops.readout_kernels import coefficient_batch_k1

    chain, cfg = grid_read(state, scan.ks, scan.ls)
    again = coefficient_batch_k1(chain, cfg).reshape(scan.chi.shape)
    gap = float((again - scan.chi).abs().max() / scan.chi.abs().max())
    err, rel = k1_vs_plain(chain, cfg)
    log(f"[{tag}] K1 on the product chain (n {chain.n}, chi {chain.chi}, "
        f"B {cfg.shape[0]}) vs plain c128: max_abs_err {err:.3e} rel "
        f"{rel:.3e} (tol {K1_TOL:g}); against the scan's own read "
        f"{gap:.3e}")
    check(rel <= K1_TOL, f"{tag}: K1 disagrees with its plain version")
    check(gap <= K1_TOL, f"{tag}: the replayed state reads otherwise than "
          "the scan's")
    return chain, cfg


def sin_decay_on_card(n, dev, chunk=2**26):
    """The sin_decay signal (FREQ, DECAY) materialized on the card in
    float32, evaluated in float64 a chunk at a time."""
    N = 2**n
    dt = 1.0 / (FREQ * N)
    x = torch.empty(N, dtype=torch.float32, device=dev)
    for lo in range(0, N, chunk):
        j = torch.arange(lo, min(N, lo + chunk), dtype=torch.float64,
                         device=dev)
        x[lo:lo + j.numel()] = torch.sin(FREQ * dt * j) * torch.exp(
            -DECAY * dt * j)
    return x


def phase_gate_pole(dev):
    """The reference tutorial's pole search on the gate path: n=20,
    chi=128, ZTPipeline(engine="gate", readout="apply"), two gate builds
    (wr = 2 pi and 0.5), the zip-up apply and K1 reads of the product
    states. The search is timed whole; its stages are then replayed
    through the same entry points, each timed, and K1 is held against its
    plain version at every scan's configs on the replayed product
    states."""
    import qilaplace_tpu_torch as qt

    n = POLE_BITS
    N = 2**n

    def signal():
        j = torch.arange(N, dtype=torch.float64, device=dev)
        return (torch.exp(-POLE_LAM * j) * torch.sin(POLE_W * j)).float()

    reset_counts()
    with k2_by_call("gate-pole"):
        x, _ = synced(signal)
        psi, t_enc = synced(lambda: qt.signal_ztmps(
            x, cutoff=1e-12, maxdim=CHI, device=dev))
        del x
        pipe = qt.ZTPipeline(n, chi=CHI, build_cutoff=GATE_CUTOFF,
                             engine="gate", readout="apply", cache=False,
                             device=dev)
        res, t_search = synced(lambda: pipe.find_poles(
            psi, coarse_points=128, fine_points=128, superfine_half=24))
    counts = read_counts()
    z = complex(res.z_pole)
    poles = [complex(math.exp(-POLE_LAM) * complex(math.cos(POLE_W),
                                                   s * math.sin(POLE_W)))
             for s in (1, -1)]
    dist = min(abs(z - p) for p in poles)
    bar = max(5e-4, 4 * 8 * 2 * math.pi / N)
    log(f"[gate-pole] n={n}: encode_s {t_enc:.4f} (psi rank "
        f"{qt.max_bond(psi)}, chi {psi.chain.chi}); search {t_search:.4f} s")
    log(f"[gate-pole] peak (k, l) = ({int(res.superfine.k_peak)}, "
        f"{int(res.superfine.l_peak)}), z_pole {z!r}, distance to the pole "
        f"{dist:.3e} (bar {bar:.3e})")
    log_counts("gate-pole", counts)
    check(bool(torch.isfinite(torch.view_as_real(res.superfine.chi)).all()),
          "gate pole search: readout not finite")
    check(counts["k1"] > 0, "the gate pole search never launched K1")
    check(counts["k2"] > 0, "the gate pole search never launched K2")
    check(dist < bar, f"gate pole search missed the pole ({dist:.3e})")

    # the replay: the search's two transforms, as coarse_to_fine_pole_search
    # forms them, each stage timed; K1 checked at each scan's configs
    stages = {}
    for wr, scans in ((2 * math.pi, ("coarse",)),
                      (0.5, ("fine", "superfine"))):
        W, t_build = synced(lambda: qt.zt_mpo(
            n, wr, engine="gate", cutoff=GATE_CUTOFF, maxdim=CHI, chi=CHI,
            dtype=torch.complex64, cache=False, device=dev))
        out, t_apply = synced(lambda: qt.apply(qt.tighten(W), psi,
                                               maxdim=CHI,
                                               cutoff=GATE_CUTOFF))
        for name in scans:
            check_k1_read(f"gate-pole {name}", out, getattr(res, name))
        stages[wr] = (t_build, t_apply, qt.max_bond(W), out.chain.chi)
    log("[gate-pole] replayed stages: " + "; ".join(
        f"wr {wr:g}: build_s {b:.4f} apply_s {a:.4f} (mpo bond {bd}, "
        f"product state chi {c})" for wr, (b, a, bd, c) in stages.items()))
    return counts


def phase_dt(dev):
    """DTPipeline(20, 2 pi, chi=64, build_cutoff=1e-9) on the sin_decay
    signal, read at 4096 (k, j) against x_j e^{-wr k j / N} / sqrt(N)."""
    import qilaplace_tpu_torch as qt

    n = DT_BITS
    N = 2**n
    reset_counts()
    x = sin_decay_on_card(n, dev)
    pipe, t_build = synced(lambda: qt.DTPipeline(
        n, WR, chi=DT_CHI, build_cutoff=GATE_CUTOFF, device=dev))
    psi, t_enc = synced(lambda: pipe.encode(x))
    out, t_apply = synced(lambda: pipe.forward(psi))
    rng = np.random.default_rng(20)
    h = N_SCAN // 2
    ks = np.concatenate([rng.integers(0, 256, h), rng.integers(0, N, h)])
    js = rng.integers(0, N, N_SCAN)
    got, t_read = synced(lambda: pipe.coefficients(
        out, torch.from_numpy(ks).to(dev), torch.from_numpy(js).to(dev)))
    counts = read_counts()
    got = got.cpu().numpy().astype(np.complex128)
    dt = 1.0 / (FREQ * N)
    xj = np.sin(FREQ * dt * js) * np.exp(-DECAY * dt * js)
    want = xj * np.exp(-WR * ks.astype(np.float64) * js / N) / math.sqrt(N)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    log(f"[dt] n={n}: build_s {t_build:.4f} + encode_s {t_enc:.4f} + "
        f"apply_s {t_apply:.4f} + read_s {t_read:.4f}; max_bond(W) "
        f"{qt.max_bond(pipe.mpo)}, out {qt.max_bond(out)}; "
        f"max_err_rel_peak {err:.3e} (bar {DT_BAR:g})")
    log_counts("dt", counts)
    check(bool(np.isfinite(got).all()), "DT readout not finite")
    check(err <= DT_BAR, f"DT max_err_rel_peak {err:.3e} > {DT_BAR:g}")
    return counts


def phase_gate_n30(dev):
    """The reference's published zT runtime configuration on the gate
    path, once: n=30 sin_decay materialized, rsvd encode (k=50, p=5,
    q=2), build_zt_mpo at cutoff 1e-9 / chi 128 in complex64 (its two
    steps called in turn, so that build_s splits into the factor folds
    and the fuse), the zip-up apply and a chi_grid read of GRID x GRID
    near-peak points of scan_samples(30). Accuracy is logged, not gated.
    Returns the counts and the read's chain and configs."""
    import qilaplace_tpu_torch as qt
    from qilaplace_tpu_torch.signals.oracles import (
        sin_decay_norm,
        sin_decay_zt_oracle,
    )
    from qilaplace_tpu_torch.transforms import zt as zt_mod
    from qilaplace_tpu_torch.utils.config import bucket_for

    n = N_BITS
    reset_counts()
    x, t_sig = synced(lambda: sin_decay_on_card(n, dev))
    with k2_by_call("gate-n30"):
        psi, t_enc = synced(lambda: qt.signal_ztmps(
            x, method="rsvd", k=50, p=5, q=2, cutoff=GATE_CUTOFF,
            maxdim=CHI, device=dev))
        del x
        torch.cuda.empty_cache()
        # build_zt_mpo(n, WR, cutoff=GATE_CUTOFF, maxdim=CHI, chi=CHI,
        # dtype=complex64): both factors at the default bucket, folded
        # together as one batched program, then fused
        (W_dt, W_qft), t_fold = synced(
            lambda: zt_mod._build_factors_concurrent(
                n, WR, cutoff=GATE_CUTOFF, maxdim=CHI, chi_f=bucket_for(32),
                dtype=torch.complex64, chi_work_f=None, device=dev))
        W, t_fuse = synced(lambda: zt_mod._fuse_factors(
            W_dt, W_qft, chi=CHI, cutoff=GATE_CUTOFF, maxdim=CHI))
    del W_dt, W_qft
    out, t_apply = synced(lambda: qt.apply(W, psi, maxdim=CHI,
                                           cutoff=GATE_CUTOFF))
    ks_all, ls_all, _ = scan_samples(n)
    ks, ls = ks_all[:GRID], ls_all[:GRID]  # near-peak half
    ks_t, ls_t = torch.from_numpy(ks).to(dev), torch.from_numpy(ls).to(dev)
    vals, t_read = synced(lambda: qt.chi_grid(out, ks_t, ls_t))
    counts = read_counts()
    got = vals.cpu().numpy().astype(np.complex128).reshape(-1)
    K, L = np.meshgrid(ks, ls, indexing="ij")
    want = sin_decay_zt_oracle(n, K.reshape(-1), L.reshape(-1), wr=WR,
                               freq=FREQ, decay_rate=DECAY)
    nrm = sin_decay_norm(n, freq=FREQ, decay_rate=DECAY)
    err = float(np.abs(got / nrm - want).max() / np.abs(want).max())
    t_build = t_fold + t_fuse
    total = t_enc + t_build + t_apply + t_read
    log(f"[gate-n30] n={n}: total {total:.4f} s = encode_s {t_enc:.4f} + "
        f"build_s {t_build:.4f} (factor folds {t_fold:.4f} + fuse "
        f"{t_fuse:.4f}) + apply_s {t_apply:.4f} + read_s {t_read:.4f} "
        f"(signal {t_sig:.4f} s, not counted)")
    log(f"[gate-n30] max_bond(W) {qt.max_bond(W)} (ranks "
        f"{W.chain.ranks.tolist()}); psi rank {qt.max_bond(psi)}, out "
        f"{qt.max_bond(out)} (chi {out.chain.chi}); max_err_rel_peak "
        f"{err:.3e} over the {GRID}x{GRID} grid (recorded, not gated)")
    log_counts("gate-n30", counts)
    check(vals.shape == (GRID, GRID), "n=30 gate read shape")
    check(bool(np.isfinite(got).all()), "n=30 gate read not finite")
    check(np.isfinite(err), "n=30 gate error not finite")
    check(counts["k1"] > 0, "the n=30 gate read never launched K1")
    chain, cfg = grid_read(out, ks_t, ls_t)
    k1_err, k1_rel = k1_vs_plain(chain, cfg)
    log(f"[gate-n30] K1 on the product chain (n {chain.n}, chi {chain.chi},"
        f" B {cfg.shape[0]}) vs plain c128: max_abs_err {k1_err:.3e} rel "
        f"{k1_rel:.3e} (tol {K1_TOL:g})")
    check(k1_rel <= K1_TOL, "K1 disagrees with its plain version on the "
          "n=30 gate product chain")
    return counts, (chain, cfg)


def phase_fold_slots(dev, n=POLE_BITS):
    """The batched factor fold against its stacks folded alone: the n=20
    gate build's fold (wr = 2 pi, cutoff 1e-9, factor bucket 32, complex64;
    Part 1, Part 2 and the paired-QFT stack as one compose_layers call on
    the inputs zt._factor_stacks gives), then each stack folded alone
    through the unbatched compose_layers on the same inputs. The batched
    fold must launch K2 as often as one stack alone, every launch with
    B = the stack count, and neither may run the plain Jacobi solver on
    the card. Every slot must have its stack's bonds and cores within
    FOLD_SLOT_TOL of the largest entry: K2 gives each slot what it gives
    the matrix alone, and the fold's products, sums and scans run a slot
    at a time on the card (complexlinalg.per_slot), so the slots are
    bit-identical to their stacks (logged). Then K2 at each of the fold's
    shapes on distinct matrices, one a slot, against each matrix launched
    alone: bit-identical. Both folds are timed (host clock,
    synchronised)."""
    from qilaplace_tpu_torch.core.mpo import MPO
    from qilaplace_tpu_torch.ops import jacobi_kernels as jk
    from qilaplace_tpu_torch.ops.apply import compose_layers
    from qilaplace_tpu_torch.transforms.zt import _factor_stacks
    from qilaplace_tpu_torch.utils.config import bucket_for

    acc, lay_c, lay_r, kw = _factor_stacks(
        n, WR, cutoff=GATE_CUTOFF, maxdim=CHI, chi_f=bucket_for(32),
        dtype=torch.complex64, chi_work_f=None, device=dev)
    S = lay_c.shape[0]
    reset_counts()
    out, t_batch = synced(lambda: compose_layers(acc, lay_c, lay_r, **kw))
    counts = read_counts()
    log_counts(f"fold-slots n={n}, {S} stacks batched", counts)
    check(counts["plain_cuda"] == 0, "the batched fold ran the plain Jacobi "
          "solver on the card")
    check(counts["k2"] > 0 and {B for _, B, _, _ in counts["k2_by_shape"]}
          == {S}, f"the batched fold's K2 launches are not all at B = {S}")
    t_alone, worst, identical = 0.0, 0.0, True
    for s in range(S):
        reset_counts()
        ref, secs = synced(lambda: compose_layers(
            MPO(cores=acc.cores[s], ranks=acc.ranks[s]), lay_c[s], lay_r[s],
            **kw))
        alone = read_counts()
        t_alone += secs
        gap = float((out.cores[s] - ref.cores).abs().max()
                    / ref.cores.abs().max())
        same = bool(torch.equal(out.cores[s], ref.cores))
        worst, identical = max(worst, gap), identical and same
        log(f"[fold-slots] slot {s}: bonds {out.ranks[s].tolist()}, alone "
            f"{ref.ranks.tolist()}; cores {gap:.3e} of the largest entry "
            f"apart (tol {FOLD_SLOT_TOL:g}), bit-identical {same}; alone "
            f"{secs:.4f} s, K2 {alone['k2']}")
        check(alone["plain_cuda"] == 0, "a stack folded alone ran the plain "
              "Jacobi solver on the card")
        check(alone["k2"] == counts["k2"], f"stack {s} alone launched K2 "
              f"{alone['k2']} times, the batched fold {counts['k2']}")
        check(out.ranks[s].tolist() == ref.ranks.tolist(),
              f"slot {s} of the batched fold has other bonds than its stack")
        check(gap <= FOLD_SLOT_TOL, f"slot {s} of the batched fold is "
              f"{gap:.3e} from its stack folded alone (tol {FOLD_SLOT_TOL:g})")
    log(f"[fold-slots] n={n}: the batched fold {t_batch:.4f} s ({counts['k2']}"
        f" K2 launches at B = {S}) against {t_alone:.4f} s for the {S} "
        f"stacks folded one after the other ({S * counts['k2']} at B = 1)")
    rng = np.random.default_rng(2030)
    for m, B, kind, sweeps in sorted(counts["k2_by_shape"]):
        H = torch.from_numpy(hermitian(rng, B, m, complex_=kind == "c64")
                             ).to(dev)
        lam, V = jk.jacobi_eigh_k2(H, sweeps=sweeps)
        alone = [jk.jacobi_eigh_k2(H[b:b + 1], sweeps=sweeps)
                 for b in range(B)]
        torch.cuda.synchronize()
        same = all(torch.equal(lam[b], a[0][0]) and torch.equal(V[b], a[1][0])
                   for b, a in enumerate(alone))
        log(f"[fold-slots] K2 {kind} m={m} B={B} sweeps={sweeps}, distinct "
            f"slots: every slot equal to its matrix alone: {same}")
        check(same, f"K2 {kind} m={m} B={B}: a slot differs from its matrix "
              "alone")
    return dict(stacks=S, batched_s=t_batch, alone_s=t_alone,
                launches_batched=counts["k2"], launches_alone=S * counts["k2"],
                max_core_gap=worst, tol=FOLD_SLOT_TOL,
                bit_identical=identical)


# ------------------------------ batched path --------------------------------

def sin_batch_on_card(n, dev, chunk=2**26):
    """BATCH signals x_{b,j} = sin(a_b j), a_b = (b + 1) / N, float32
    [BATCH, N] made on the card, evaluated in float64 a chunk at a time."""
    N = 2**n
    x = torch.empty(BATCH, N, dtype=torch.float32, device=dev)
    for lo in range(0, N, chunk):
        j = torch.arange(lo, min(N, lo + chunk), dtype=torch.float64,
                         device=dev)
        a = torch.arange(1, BATCH + 1, dtype=torch.float64,
                         device=dev)[:, None] / N
        x[:, lo:lo + j.numel()] = torch.sin(a * j)
    return x


def phase_batched_qft(dev, smi, n=QFT_BITS):
    """The batched QFT path: batched_qft_pipeline over BATCH signals
    (shard_batch on a mesh of this card, W replicated) at n=28, chi 64,
    cutoff 1e-9, W = build_qft_mpo(28, chi=64, cutoff=1e-9) in complex64,
    read at phase 7's 4096 frequencies. Each row against its closed form
    (bar QFT_BARS[28]) and against the one-signal path
    coefficient_batch(apply(W, signal_mps(x_b))) on the card (relative to
    the peak, bar BATCH_BAR); K2's launches over the batch must equal those
    over one signal, each with B = BATCH. Returns the batch's counts, the
    one signal's counts and the figures logged."""
    import qilaplace_tpu_torch as qt
    from qilaplace_tpu_torch.parallel import (
        batched_qft_pipeline,
        make_mesh,
        replicate,
        shard_batch,
    )
    from qilaplace_tpu_torch.utils.bits import tensor_int_to_bits

    ks = qft_freqs(n)
    configs = tensor_int_to_bits(torch.from_numpy(ks).to(dev), n,
                                 order="lsb").to(torch.int32)
    reset_counts()
    W, t_build = synced(lambda: qt.build_qft_mpo(
        n, chi=QFT_CHI, cutoff=QFT_CUTOFF, dtype=torch.complex64, device=dev))
    build_counts = read_counts()
    xs, t_sig = synced(lambda: sin_batch_on_card(n, dev))

    def one_signal(x):
        psi = qt.signal_mps(x, cutoff=QFT_CUTOFF, chi=QFT_CHI, device=dev)
        out = qt.apply(W, psi, maxdim=QFT_CHI, cutoff=QFT_CUTOFF)
        return qt.coefficient_batch(out, configs)

    mesh = make_mesh(1, devices=[dev])
    W_repl = replicate(mesh, W)
    xs_sharded = shard_batch(mesh, xs)

    def batch():
        return batched_qft_pipeline(W_repl, xs_sharded, configs, chi=QFT_CHI,
                                    cutoff=QFT_CUTOFF)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    got, t_batch = synced(batch)
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    rows, loop_s, one_counts = [], [], None
    for b in range(BATCH):
        if b == 0:
            reset_counts()
        row, secs = synced(lambda: one_signal(xs[b]))
        if b == 0:
            one_counts = read_counts()
        rows.append(row)
        loop_s.append(secs)
    _, t_batch2 = synced(batch)
    ref = torch.stack(rows)
    check(got.shape == (BATCH, len(ks)), "batched QFT readout shape")
    check(bool(torch.isfinite(torch.view_as_real(got)).all()),
          "batched QFT readout not finite")
    got_np = got.cpu().numpy().astype(np.complex128)
    closed = [float(np.abs(got_np[b] - sin_spectrum(n, ks, b + 1)).max()
                    / np.abs(sin_spectrum(n, ks, b + 1)).max())
              for b in range(BATCH)]
    vs_one = [float((got[b] - ref[b]).abs().max() / ref[b].abs().max())
              for b in range(BATCH)]
    log(f"[batch] n={n} B={BATCH}: build_qft_mpo(chi {QFT_CHI}, cutoff "
        f"{QFT_CUTOFF:g}, complex64) {t_build:.4f} s (bond "
        f"{qt.max_bond(W)}, K2 {build_counts['k2']}); signals {t_sig:.4f} "
        f"s (not counted)")
    log(f"[batch] batched_qft_pipeline {t_batch:.4f} s and {t_batch2:.4f} s "
        f"(after the loop) against 8 one-signal runs {sum(loop_s):.4f} s "
        f"({', '.join(f'{t:.4f}' for t in loop_s)}); "
        f"max_memory_allocated {peak_gib:.2f} GiB; card {smi}")
    log(f"[batch] max_err_rel_peak per row vs the closed form: "
        + ", ".join(f"{e:.3e}" for e in closed) + f" (bar {QFT_BARS[n]:g}); "
        "vs the one-signal path: " + ", ".join(f"{e:.3e}" for e in vs_one)
        + f" (bar {BATCH_BAR:g})")
    log_counts("batch", counts)
    log_counts("batch one signal", one_counts)
    check(counts["k2"] > 0, "the batched QFT path never launched K2")
    check(counts["k2"] == one_counts["k2"],
          f"K2 launches: batch {counts['k2']} != one signal "
          f"{one_counts['k2']}")
    check(all(key[1] == BATCH for key in counts["k2_by_shape"]),
          "a batched K2 launch without the whole batch")
    check(max(closed) <= QFT_BARS[n],
          f"batched QFT vs closed form {max(closed):.3e}")
    check(max(vs_one) <= BATCH_BAR,
          f"batched QFT vs one-signal path {max(vs_one):.3e}")
    del xs, xs_sharded, rows, ref, got
    torch.cuda.empty_cache()
    return counts, one_counts, dict(
        batch_s=t_batch, batch2_s=t_batch2, loop_s=sum(loop_s),
        peak_gib=peak_gib, max_err_closed=max(closed),
        max_err_one=max(vs_one))


def scan_configs(n, count, seed=0):
    """The reference runner's uniform scan configurations
    (scripts/benchmark/batched_scan.py): interleaved LSB-first (k, l)."""
    rng = np.random.default_rng(seed)
    N = 2**n
    ks = rng.integers(0, N, count)
    ls = rng.integers(0, N, count)
    kb = ((ks[:, None] >> np.arange(n)) & 1).astype(np.int32)
    lb = ((ls[:, None] >> np.arange(n)) & 1).astype(np.int32)
    return np.stack([kb, lb], axis=2).reshape(count, 2 * n)


def phase_multi_scan(dev, smi, n=N_BITS):
    """The reference runner's multi-operator scan at n=30: cross encode at
    1e-12 / maxdim 128 then tighten, N_OPS analytic operators at
    wr = 2 pi (1 + i / N_OPS) (zt_product_pack, mpo_from_pack, complex64),
    stack_mpos, 4096 configurations of scan_configs(30, 4096). The stacked
    readout against each operator's own apply_coefficient_batch (relative
    to the peak, bar MULTI_BAR) and sharded_multi_scan on a mesh of this
    card equal to it; single against stacked, CUDA events, median of 3."""
    import qilaplace_tpu_torch as qt
    from qilaplace_tpu_torch.parallel import (
        make_mesh,
        multi_mpo_chi_batch,
        sharded_multi_scan,
        stack_mpos,
    )

    psi = qt.tighten(qt.signal_ztmps_cross(
        sin_decay_fn(n), cutoff=CUTOFF, maxdim=CHI, device="cpu"))
    psi = psi.to(dev, torch.float32)
    t0 = time.perf_counter()
    packs = [qt.zt_product_pack(n, 2 * math.pi * (1 + i / N_OPS),
                                cutoff=CUTOFF, maxdim=CHI)
             for i in range(N_OPS)]
    t_packs = time.perf_counter() - t0
    Ws = [qt.mpo_from_pack(p, device=dev, dtype=torch.complex64)
          for p in packs]
    stacked = stack_mpos(Ws)
    cfg = torch.from_numpy(scan_configs(n, N_SCAN)).to(dev)
    reset_counts()
    multi, _ = synced(lambda: multi_mpo_chi_batch(stacked, psi, cfg))
    counts = read_counts()
    singles = [qt.apply_coefficient_batch(W, psi, cfg) for W in Ws]
    errs = [float((multi[i] - s).abs().max() / s.abs().max())
            for i, s in enumerate(singles)]
    sharded = sharded_multi_scan(make_mesh(1, devices=[dev]), stacked, psi,
                                 cfg)
    torch.cuda.synchronize()
    fns = {"single": lambda: qt.apply_coefficient_batch(Ws[0], psi, cfg),
           "multi": lambda: multi_mpo_chi_batch(stacked, psi, cfg)}
    ms = {k: [] for k in fns}
    for _ in range(3):  # in turns
        for k in ("single", "multi", "multi", "single"):
            ms[k].append(event_ms(fns[k], reps=1))
    med = {k: float(np.median(v)) for k, v in ms.items()}
    per_scan = med["multi"] / N_OPS
    log(f"[multi] n={n}: {N_OPS} operators (bonds "
        f"{[qt.max_bond(W) for W in Ws]}, chi {stacked.chain.chi}), psi "
        f"rank {qt.max_bond(psi)} (chi {psi.chain.chi}), {N_SCAN} configs; "
        f"host packs {t_packs:.4f} s")
    log(f"[multi] stacked vs single per operator, rel to peak: "
        + ", ".join(f"{e:.3e}" for e in errs) + f" (bar {MULTI_BAR:g}); "
        f"sharded on one card equal: {bool(torch.equal(sharded, multi))}")
    log(f"[multi] single scan {med['single']:.4f} ms "
        f"({1e3 * med['single'] / N_SCAN:.4f} us a point); stacked "
        f"{med['multi']:.4f} ms for {N_OPS}: {per_scan:.4f} ms a scan "
        f"({1e3 * per_scan / N_SCAN:.4f} us a point); CUDA events, median "
        f"of 3; card {smi}")
    log_counts("multi", counts)
    check(multi.shape == (N_OPS, N_SCAN), "multi-operator scan shape")
    check(bool(torch.isfinite(torch.view_as_real(multi)).all()),
          "multi-operator scan not finite")
    check(max(errs) <= MULTI_BAR,
          f"stacked scan vs single {max(errs):.3e} > {MULTI_BAR:g}")
    check(torch.equal(sharded, multi),
          "sharded_multi_scan on one card differs from multi_mpo_chi_batch")
    return dict(single_ms=med["single"], multi_ms=med["multi"],
                per_scan_ms=per_scan, max_err=max(errs))


def phase_entries(dev):
    """The entry points: entry() built and run once, then
    dryrun_multichip over every card."""
    from qilaplace_tpu_torch.entry import dryrun_multichip, entry

    reset_counts()
    (fn, args), t_setup = synced(entry)
    out, t_fn = synced(lambda: fn(*args))
    counts = read_counts()
    log(f"[entry] entry(): setup {t_setup:.4f} s, step {t_fn:.4f} s -> "
        f"{tuple(out.shape)} {out.dtype}")
    log_counts("entry", counts)
    check(out.shape == (256,) and out.dtype == torch.float32,
          "entry step shape or dtype")
    check(bool(torch.isfinite(out).all()), "entry step not finite")
    check(counts["k2"] > 0, "entry() never launched K2")
    res, secs = synced(lambda: dryrun_multichip(torch.cuda.device_count()))
    log(f"[entry] dryrun_multichip({torch.cuda.device_count()}) in "
        f"{secs:.4f} s: loss {res['loss0']:.3e} -> {res['loss1']:.3e}, "
        f"peaks {res['peaks']} (line l={res['l_line']})")


def phase_gate_trace(dev, n=POLE_BITS):
    """One n=20 gate build (wr = 2 pi, cutoff 1e-9, chi 128) under
    torch.profiler: K2's device time, all kernels and the card's busy
    share, and the K2 launches of each of its calls by shape. Device
    activity only: the build runs about 100 host ops a launch, and
    recording them too makes the trace's processing take minutes. Returns
    the wall time, the K2 launches and the busy share."""
    import qilaplace_tpu_torch as qt
    from torch.profiler import ProfilerActivity, profile

    reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            k2_by_call("gate-trace"):
        _, wall = synced(lambda: qt.build_zt_mpo(
            n, WR, cutoff=GATE_CUTOFF, maxdim=CHI, chi=CHI,
            dtype=torch.complex64, device=dev))
    counts = read_counts()
    log_counts("gate-trace", counts)
    busy = device_busy(prof, wall)
    log_trace(f"n={n} gate build", wall, busy)
    return dict(wall_s=wall, k2=counts["k2"],
                busy=None if busy is None else busy[3])


def device_busy(prof, wall_s):
    """From a torch.profiler trace: (K2's device ms, K2 launches, all device
    ms, busy share of ``wall_s``), or None where the trace holds no device
    activity. The busy share is the union of the device intervals over the
    host's wall time of the traced call."""
    from torch.autograd import DeviceType

    spans, k2_us, k2_n = [], 0.0, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        if "jacobi_" in e.name:  # every kernel of K2
            k2_us += t1 - t0
            k2_n += "jacobi_vectors_kernel" not in e.name
    if not spans:
        return None
    spans.sort()
    busy, end = 0.0, -math.inf
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    total = sum(t1 - t0 for t0, t1 in spans)
    return k2_us / 1e3, k2_n, total / 1e3, busy / 1e6 / wall_s


def phase_trace(dev, n=QFT_BITS):
    """One QFT build and one apply at n under torch.profiler; logs where
    the device time goes (see the module docstring)."""
    import qilaplace_tpu_torch as qt
    from torch.profiler import ProfilerActivity, profile

    x = qt.generate_signal(n, device=dev)
    psi = qt.QFTPipeline(n, chi=QFT_CHI, cutoff=QFT_CUTOFF,
                         device=dev).encode(x, **QFT_ENCODE)
    del x
    acts = [ProfilerActivity.CUDA]
    stages = {}
    with profile(activities=acts) as prof:
        pipe, stages["build"] = synced(lambda: qt.QFTPipeline(
            n, chi=QFT_CHI, cutoff=QFT_CUTOFF, device=dev))
    res = {"build": device_busy(prof, stages["build"])}
    with profile(activities=acts) as prof:
        _, stages["apply"] = synced(lambda: pipe.forward(psi))
    res["apply"] = device_busy(prof, stages["apply"])
    for stage, r in res.items():
        log_trace(f"n={n} {stage}", stages[stage], r)


# ------------------------------ tutorials -----------------------------------

TUTORIALS = ("signal", "dft", "dt", "zt")
# K2's group variant timed (m, complex, sweeps): the default profile at
# m = 384 and 512, the dft tutorial's m = 512 at 6 and 7 sweeps, the real
# variant
K2_GROUP_TIMED = ((384, True, 11), (512, True, 6), (512, True, 7),
                  (512, True, 11), (512, False, 7))


@contextlib.contextmanager
def k1_recorded():
    """Within the block, every module of the port that imported K1's
    wrapper calls a recorder instead, which calls the wrapper and keeps
    (chain, configs, result) of each launch; only the wrapper's own count
    moves. Yields the list of launches."""
    from qilaplace_tpu_torch.ops import readout_kernels as rk

    real, calls = rk.coefficient_batch_k1, []

    def recorder(chain, configs):
        before = real.launches
        got = real(chain, configs)
        if real.launches > before:
            calls.append((getattr(chain, "chain", chain), configs, got))
        return got

    # not readout_kernels itself: the wrapper counts through its global
    users = [m for name, m in list(sys.modules.items())
             if name.startswith("qilaplace_tpu_torch") and m is not rk
             and getattr(m, "coefficient_batch_k1", None) is real]
    for m in users:
        m.coefficient_batch_k1 = recorder
    try:
        yield calls
    finally:
        for m in users:
            m.coefficient_batch_k1 = real


def phase_tutorials(dev):
    """The four tutorials of qilaplace_tpu_torch.tutorials on the card in
    complex64, each with the counts set to 0 just before it: each run
    asserts its tutorial's facts (and raises), writes no file (its pole
    searches build with cache=False), must launch K2 and run no plain
    Jacobi call on the card; zt must launch K1. After each run, every K1
    launch it made is held against K1's plain version in complex128 on the
    same chain and configs. Returns per tutorial its wall time and
    counts."""
    import importlib

    out = {}
    for name in TUTORIALS:
        tutorial = importlib.import_module(f"qilaplace_tpu_torch.tutorials.{name}")
        with k1_recorded() as k1_calls, k2_by_call(f"tutorial {name}"):
            reset_counts()
            _, wall = synced(lambda: tutorial.run(device=dev,
                                                  dtype=torch.complex64))
            counts = read_counts()
        check(len(k1_calls) == counts["k1"],
              f"{name}: {len(k1_calls)} K1 launches recorded, "
              f"{counts['k1']} counted")
        for i, (chain, cfg, got) in enumerate(k1_calls):
            err, rel = k1_err(got, chain, cfg)
            log(f"[tutorial] {name}: K1 launch {i} (n {chain.n}, chi "
                f"{chain.chi}, B {cfg.shape[0]}) vs plain c128: max_abs_err "
                f"{err:.3e} rel {rel:.3e} (tol {K1_TOL:g})")
            check(rel <= K1_TOL, f"{name}: K1 launch {i} disagrees with its "
                  "plain version")
        log_counts(f"tutorial {name}", counts)
        max_m = max((m for m, _, _, _ in counts["k2_by_shape"]), default=0)
        log(f"[tutorial] {name}: wall {wall:.4f} s (host clock, synchronised), "
            f"K1 launches {counts['k1']}, K2 launches {counts['k2']}, largest "
            f"K2 m {max_m}, plain Jacobi calls on the card "
            f"{counts['plain_cuda']}")
        check(counts["k2"] > 0, f"the {name} tutorial launched no K2")
        out[name] = dict(counts, wall_s=wall, k2_max_m=max_m)
    check(out["zt"]["k1"] > 0, "the zt tutorial launched no K1")
    return out


def log_trace(what, wall, r):
    """One line of a traced stage: ``r`` is device_busy's result."""
    if r is None:
        log(f"[trace] {what}: wall {wall:.4f} s under the profiler; no "
            "device activity in the trace (not measured)")
        return
    k2_ms, k2_n, dev_ms, busy = r
    log(f"[trace] {what}: wall {wall:.4f} s under the profiler; K2 "
        f"{k2_ms:.2f} ms device time in {k2_n} launches "
        f"({k2_ms / max(k2_n, 1) * 1e3:.1f} us each, "
        f"{k2_ms / 10 / wall:.1f} % of the wall time); all kernels "
        f"{dev_ms:.2f} ms; card busy {100 * busy:.1f} % of the wall time")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card")
    import qilaplace_tpu_torch  # noqa: F401  (sets full-fp32 matmuls)
    from qilaplace_tpu_torch.ops.jacobi_kernels import jacobi_eigh_k2
    from qilaplace_tpu_torch.ops.readout_kernels import coefficient_batch_k1

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def mark(what):
        log(f"[clock] {what} done at {time.perf_counter() - t_start:.1f} s")

    smi = phase_env()
    phase_build()
    mark("build")
    primitives = phase_k2_primitives(smi)
    ks, ls, cfg_np = scan_samples(N_BITS)
    configs = torch.from_numpy(cfg_np).to(dev)
    phase_k1_check(dev, configs)
    k2_err = max(phase_k2_check(dev), phase_k2_cluster_stress(dev))
    mark("K1 and K2 checks")
    phase_readout_routes(dev)
    mark("readout routes")

    coefficient_batch_k1.launches = 0
    jacobi_eigh_k2.launches = 0
    chain = phase_main_path(dev, ks, ls, configs)
    k1_zt = coefficient_batch_k1.launches
    log(f"[main] K1 launches on the zT path: {k1_zt} (K2: "
        f"{jacobi_eigh_k2.launches})")
    check(k1_zt > 0, "the zT path never launched K1")

    phase_pole(dev)
    mark("zT path and pole search")
    qft_err, qft_counts, qft_read = phase_qft(dev, QFT_BITS, runs=2)
    _, qft16_counts, _ = phase_qft(dev, 16)
    k2_err = max(k2_err, phase_k2_path_shapes(
        dev, set(qft_counts["k2_by_shape"]) | set(qft16_counts["k2_by_shape"])))
    mark("QFT path")

    # the gate path: each phase sets the counts to 0 just before it
    pole_counts = phase_gate_pole(dev)
    dt_counts = phase_dt(dev)
    n30_counts, n30_read = phase_gate_n30(dev)
    fold_slots = phase_fold_slots(dev)
    gate = [pole_counts, dt_counts, n30_counts]
    gate_shapes = {}
    for c in gate:
        for sh, k in c["k2_by_shape"].items():
            gate_shapes[sh] = gate_shapes.get(sh, 0) + k
    new_shapes = set(gate_shapes) - set(qft_counts["k2_by_shape"]) \
        - set(qft16_counts["k2_by_shape"])
    log(f"[gate] K2 launches by shape over the gate phases: "
        + ", ".join(f"({kind} m={m}, B={B}, sweeps={sw}): {c}"
                    for (m, B, kind, sw), c in sorted(
                        gate_shapes.items(), key=lambda kv: -kv[1]))
        + f"; {len(new_shapes)} shapes no earlier path launched")
    k2_err = max(k2_err, phase_k2_path_shapes(dev, new_shapes))
    mark("gate path")

    # the batched path: each phase sets the counts to 0 just before it
    batch_counts, one_counts, batch_figs = phase_batched_qft(dev, smi)
    batch_shapes = set(batch_counts["k2_by_shape"])
    k2_err = max(k2_err, phase_k2_path_shapes(dev, batch_shapes),
                 phase_k2_batch_slots(dev))
    multi = phase_multi_scan(dev, smi)
    phase_entries(dev)
    mark("batched path and entries")

    k1 = phase_timing(chain, configs, smi, "zT chain")
    k1_qft = phase_timing(*qft_read, smi, f"QFT n={QFT_BITS} readout chain")
    k1_gate = phase_timing(*n30_read, smi, "n=30 gate product chain")
    # K2 timed at the gate phases' three most launched new shapes, at every
    # shape of theirs on the cluster variant and at CLUSTER_SHAPES
    from qilaplace_tpu_torch.ops.jacobi_kernels import (
        CLUSTER_MAX_M,
        SMEM_MAX_M,
    )

    ranked = sorted(new_shapes, key=lambda sh: -gate_shapes[sh])
    cluster = sorted(sh for sh in gate_shapes
                     if SMEM_MAX_M < sh[0] <= CLUSTER_MAX_M)
    top = ranked[:3] + [sh for sh in cluster if sh not in ranked[:3]]
    k2_times = phase_k2_timing(
        smi, QFT_K2_SHAPES + [(m, B, kind == "c64", sw)
                              for m, B, kind, sw in top]
        + list(CLUSTER_SHAPES))
    device_memory = [dict(r, launches=gate_shapes.get(r["key"], 0))
                     for r in k2_times if SMEM_MAX_M < r["key"][0]]
    # K2 at every shape the batched phase launched, beside its plain
    # version and the batched torch.linalg.eigh
    batched = [dict(r, launches=batch_counts["k2_by_shape"][r["key"]])
               for r in phase_k2_timing(
                   smi, [(m, B, kind == "c64", sw)
                         for m, B, kind, sw in sorted(batch_shapes)])]
    mark("timing")
    phase_trace(dev)
    mark("QFT trace")
    gate_trace = phase_gate_trace(dev)
    mark("gate trace")

    # the tutorials: each sets the counts to 0 just before it
    tutorials = phase_tutorials(dev)
    tut_shapes = collections.Counter()
    for t in tutorials.values():
        tut_shapes.update(t["k2_by_shape"])
    earlier = collections.Counter()
    for c in [qft_counts, qft16_counts, *gate, batch_counts, one_counts]:
        earlier.update(c["k2_by_shape"])
    k2_err = max(k2_err, phase_k2_path_shapes(dev, set(tut_shapes)
                                              - set(earlier)))
    mark("tutorials")
    # K2's group variant (m > CLUSTER_MAX_M) at K2_GROUP_TIMED, B = 1, and
    # every shape of it that a phase launched, with the launches of every
    # phase
    every = earlier + tut_shapes
    group_timed = [(m, 1, cplx, sw) for m, cplx, sw in K2_GROUP_TIMED]
    group_timed += sorted((m, B, kind == "c64", sw)
                          for m, B, kind, sw in every if m > CLUSTER_MAX_M)
    group = [
        dict(r, launches=every[r["key"]],
             launches_before_tutorials=earlier[r["key"]])
        for r in phase_k2_timing(smi, group_timed, plain_reps=1, reps=10)]
    mark("K2 group timing")
    # K2's line: its most launched shape on the QFT path (the build's
    # two-site polish, m = 24); every shape's numbers are logged above,
    # the gate path's in "gate_shapes"
    k2 = k2_times[0]
    log(json.dumps({"kernels": [{
        "name": "coefficient_batch_k1",
        "route": "cuda",
        "source": "qilaplace_tpu_torch/csrc/coefficient_batch.cu",
        "replaces": "qilaplace_tpu/ops/pallas_kernels.py:58",
        "launches": k1_zt,
        "launches_qft": qft_counts["k1"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "alone_ms": k1["alone_ms"],
        "prepass_ms": k1["prepass_ms"],
        "padded_work_ms": k1["padded_work_ms"],
        "live_share": k1["live_share"],
        "qft": {k: k1_qft[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "alone_ms", "prepass_ms",
                                       "padded_work_ms", "live_share",
                                       "max_abs_err")},
        "launches_gate_pole": pole_counts["k1"],
        "launches_gate_n30": n30_counts["k1"],
        "gate": {k: k1_gate[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "alone_ms", "prepass_ms",
                                        "padded_work_ms", "live_share",
                                        "max_abs_err")},
    }, {
        "name": "jacobi_eigh_k2",
        "route": "cuda",
        "source": "qilaplace_tpu_torch/csrc/jacobi_eigh.cu",
        "replaces": "qilaplace_tpu/ops/jacobi.py:302",
        "launches": qft_counts["k2"],
        "max_abs_err": k2_err,
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
        "shape": k2["shape"],
        "qft_max_err_rel_peak": qft_err,
        "launches_gate": {"pole_n20": pole_counts["k2"],
                          "dt_n20": dt_counts["k2"],
                          "zt_n30": n30_counts["k2"],
                          "build_n20_traced": gate_trace["k2"]},
        "gate_build_n20_traced": gate_trace,
        "fold_slots_n20": fold_slots,
        "gate_shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms",
                                           "library_ms", "bound_ms",
                                           "bound_by")}
                        for r in k2_times[4:]],
        "device_memory": [{k: r[k] for k in (
            "shape", "launches", "ms", "us_a_round", "plain_ms", "library_ms",
            "bound_ms", "bound_by")} for r in device_memory],
        "launches_batched_qft": batch_counts["k2"],
        "launches_one_signal": one_counts["k2"],
        "batched_shapes": [{k: r[k] for k in (
            "shape", "launches", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")} for r in batched],
        "batched_qft": batch_figs,
        "multi_scan": multi,
        "group": [{k: r[k] for k in (
            "shape", "launches", "launches_before_tutorials", "ms",
            "us_a_round", "plain_ms", "library_ms", "bound_ms", "bound_by")}
            for r in group],
        "primitives_us": primitives,
        "tutorials": {name: {k: t[k] for k in ("wall_s", "k1", "k2",
                                               "k2_max_m")}
                      for name, t in tutorials.items()},
    }]}))
    log(f"[clock] total {time.perf_counter() - t_start:.1f} s; card {smi}")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
