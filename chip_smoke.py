"""Smoke run of the PyTorch port (qilaplace_tpu_torch) on one CUDA card.

Drives the port's main path once, the n=30 zT pole scan that bench.py
times for the JAX package, and checks it:

1. env       torch / CUDA versions, the card, its power limit;
2. build     kernel K1 from qilaplace_tpu_torch/csrc with nvcc (sm_90a);
3. K1 check  K1 against its plain torch version (run in complex128) on the
             card: the main-path shape (60 sites, chi 256, the 4096 scan
             configurations), a chi=8 chain with B=5, a chi=32 chain with
             B=1000; tolerance max |delta| / max |ref| <= 1e-5;
4. main path n=30: cross encode of the sin_decay signal, analytic build of
             the zT factor pack, assembly on the card, direct readout of
             the 4096 scan points (zipper_chain + K1), scored against the
             closed-form oracle; then the multi_sin_exp family through the
             same entry point (the factored route). Median of 3 after a
             warm-up;
5. pole      ZTPipeline(30).find_poles(readout="direct"); the pole must lie
             within 64 * 2 pi / N of e^{-lambda +- i w};
6. timing    K1 against its plain version on the main path's own chain.

Every failure raises. Without a CUDA device the script exits nonzero at
once. The last line of stdout is one JSON object naming the device.

Run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time

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


def log(*args):
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


# ------------------------------ workload ------------------------------------

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
    from qilaplace_tpu_torch.ops.readout_kernels import build_k1

    info = build_k1()
    log(f"[build] K1 {'reused' if info['cached'] else 'built'} in "
        f"{info['seconds']:.2f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build]   {line.strip()}")


def random_chain(rng, n, chi, dev):
    """Unit-scale random complex64 chain; entries ~ N(0, 1/(2 chi)) per
    part keep |v| O(1) along the chain."""
    from qilaplace_tpu_torch import MPS

    s = 1.0 / math.sqrt(2 * chi)
    cores = (rng.normal(size=(n, chi, 2, chi))
             + 1j * rng.normal(size=(n, chi, 2, chi))) * s
    return MPS(cores=torch.from_numpy(cores.astype(np.complex64)).to(dev),
               ranks=torch.full((n + 1,), chi, dtype=torch.int32, device=dev),
               amplitude=torch.tensor(1.0, device=dev))


def k1_vs_plain(chain, cfg):
    """(max abs err, max abs err / max |ref|) of K1 against the plain
    version run in complex128 on the same inputs."""
    from qilaplace_tpu_torch.ops.readout_kernels import (
        coefficient_batch_k1,
        coefficient_batch_k1_reference,
    )

    got = coefficient_batch_k1(chain, cfg)
    torch.cuda.synchronize()
    check(got.shape == (cfg.shape[0],), "K1 output shape")
    check(bool(torch.isfinite(torch.view_as_real(got)).all()),
          "K1 output not finite")
    ref = coefficient_batch_k1_reference(chain.to(dtype=torch.complex128), cfg)
    torch.cuda.synchronize()
    err = float((got.to(torch.complex128) - ref).abs().max())
    return err, err / float(ref.abs().max())


def phase_k1_check(dev, cfg_main):
    rng = np.random.default_rng(2024)
    cases = [("main-path shape", 2 * N_BITS, 256, cfg_main),
             ("chi=8 n=5 B=5", 5, 8, None),
             ("chi=32 n=20 B=1000", 20, 32, None)]
    for name, n, chi, cfg in cases:
        chain = random_chain(rng, n, chi, dev)
        if cfg is None:
            B = 5 if chi == 8 else 1000
            cfg = torch.from_numpy(
                rng.integers(0, 2, (B, n)).astype(np.int32)).to(dev)
        err, rel = k1_vs_plain(chain, cfg)
        log(f"[k1] {name}: max_abs_err {err:.3e} rel {rel:.3e} "
            f"(tol {K1_TOL:g})")
        check(rel <= K1_TOL, f"K1 disagrees with its plain version ({name})")


def phase_main_path(dev, ks, ls, configs):
    import qilaplace_tpu_torch as qt

    def setup():
        t0 = time.perf_counter()
        psi = qt.tighten(qt.signal_ztmps_cross(
            sin_decay_fn(N_BITS), cutoff=CUTOFF, maxdim=CHI))
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

    def scan(W, psi_d):
        return synced(lambda: qt.direct_vals(W, psi_d, configs))

    W, psi_d, _ = setup()
    scan(W, psi_d)  # warm-up
    runs = []
    for _ in range(3):
        W, psi_d, parts = setup()
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
    psi2 = qt.tighten(qt.signal_ztmps_cross(f2, cutoff=CUTOFF, maxdim=CHI))
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


def phase_timing(chain, cfg, smi):
    from qilaplace_tpu_torch.ops.readout_kernels import (
        coefficient_batch_k1,
        coefficient_batch_k1_reference,
    )

    err, rel = k1_vs_plain(chain, cfg)
    check(rel <= K1_TOL, "K1 disagrees with its plain version (main chain)")
    kernel = lambda: coefficient_batch_k1(chain, cfg)  # noqa: E731
    plain = lambda: coefficient_batch_k1_reference(chain, cfg)  # noqa: E731
    kernel(), plain()  # warm-up
    ms_plain, ms_kernel = [], []
    for _ in range(3):  # in turns: plain, kernel, kernel, plain, ...
        ms_plain.append(event_ms(plain))
        ms_kernel.append(event_ms(kernel))
        ms_kernel.append(event_ms(kernel))
        ms_plain.append(event_ms(plain))
    ms_k, ms_p = float(np.median(ms_kernel)), float(np.median(ms_plain))
    flops = 8.0 * cfg.shape[0] * chain.n * chain.chi**2
    log(f"[time] K1 on the main chain (n {chain.n}, chi {chain.chi}, B "
        f"{cfg.shape[0]}): kernel {ms_k:.3f} ms ({flops / ms_k / 1e6:.1f} "
        f"GFLOP/s), plain c64 {ms_p:.3f} ms; max_abs_err {err:.3e} rel "
        f"{rel:.3e}; card {smi}")
    return err, ms_k, ms_p


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card")
    import qilaplace_tpu_torch  # noqa: F401  (sets full-fp32 matmuls)
    from qilaplace_tpu_torch.ops.readout_kernels import coefficient_batch_k1

    dev = torch.device("cuda", 0)
    smi = phase_env()
    phase_build()
    ks, ls, cfg_np = scan_samples(N_BITS)
    configs = torch.from_numpy(cfg_np).to(dev)
    phase_k1_check(dev, configs)

    coefficient_batch_k1.launches = 0
    chain = phase_main_path(dev, ks, ls, configs)
    launches = coefficient_batch_k1.launches
    log(f"[main] K1 launches on the main path: {launches}")
    check(launches > 0, "the main path never launched K1")

    phase_pole(dev)
    err, ms_k, ms_p = phase_timing(chain, configs, smi)
    log(json.dumps({"kernels": [{
        "name": "coefficient_batch_k1",
        "route": "cuda",
        "source": "qilaplace_tpu_torch/csrc/coefficient_batch.cu",
        "replaces": "qilaplace_tpu/ops/pallas_kernels.py:58",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms_k,
        "plain_ms": ms_p,
    }]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
