"""Entry points (counterpart of the JAX package's ``__graft_entry__.py``).

entry()             the zT forward step (zip-up apply + coefficient
                    readout) of the flagship model at n=8, chi=32, with its
                    example arguments;
dryrun_multichip(n) one dp/grid-sharded step on an n-device mesh: the fit
                    step on a perturbed QFT operator (two SGD steps, which
                    must descend), the grid-sharded readout, and the n=10,
                    chi=64 multi-operator zT scan, whose peaks must lie on
                    the signal's line.

Both run on the card unless given CPU devices (``device="cpu"``,
``devices=["cpu"] * n``); float32 / complex64 throughout, as in the JAX
dry run.

Run on the card: python -m qilaplace_tpu_torch.entry
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qilaplace_tpu_torch.utils.config import resolve_device


def entry(device=None):
    """Return (fn, example_args) for the zT forward step:
    ``fn(W, psi, configs)`` applies W to psi (zip-up, chi 32) and reads
    |<config|W psi>| at 256 random (k, l) points as float32."""
    from qilaplace_tpu_torch.core.mps import coefficient_batch
    from qilaplace_tpu_torch.ops.apply import apply
    from qilaplace_tpu_torch.signals.encode import signal_ztmps
    from qilaplace_tpu_torch.transforms.zt import build_zt_mpo
    from qilaplace_tpu_torch.utils.bits import paired_config_from_kl

    device = resolve_device(device)
    n, chi = 8, 32
    j = np.arange(2**n)
    x = ((1.02**j) * np.cos(0.7 * j)).astype(np.float32)
    psi = signal_ztmps(x, cutoff=1e-10, maxdim=chi, chi=chi, device=device)
    W = build_zt_mpo(n, 2 * np.pi, cutoff=1e-10, maxdim=chi, chi=chi,
                     dtype=torch.complex64, device=device)
    rng = np.random.default_rng(0)
    ks = rng.integers(0, 2**n, size=256)
    ls = rng.integers(0, 2**n, size=256)
    configs = paired_config_from_kl(ks, ls, n, device=device)

    def fn(W, psi, configs):
        out = apply(W, psi, maxdim=chi, cutoff=1e-10)
        return coefficient_batch(out, configs).abs().to(torch.float32)

    return fn, (W, psi, configs)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run one dp/grid-sharded step on an ``n_devices`` mesh (``devices``
    default: the CUDA devices). Raises if the fit does not descend or a
    scan peak misses its line; returns the figures it printed."""
    from qilaplace_tpu_torch.core.mpo import MPO
    from qilaplace_tpu_torch.core.mps import MPS, coefficient_batch
    from qilaplace_tpu_torch.ops.apply import apply
    from qilaplace_tpu_torch.parallel import (
        batched_signal_mps,
        fit_mpo_step,
        make_mesh,
        replicate,
        shard_batch,
        sharded_chi_grid,
        sharded_multi_scan,
        stack_mpos,
    )
    from qilaplace_tpu_torch.scan.pole_scan import tighten
    from qilaplace_tpu_torch.signals.encode import signal_ztmps
    from qilaplace_tpu_torch.transforms.qft import build_qft_mpo
    from qilaplace_tpu_torch.transforms.zt import zt_mpo
    from qilaplace_tpu_torch.utils.bits import (
        paired_config_from_kl,
        tensor_int_to_bits,
    )

    n, chi = 6, 8
    B = max(n_devices, 2)
    grid_ax = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices, shape=(n_devices // grid_ax, grid_ax),
                     devices=devices)
    dev = mesh.first

    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.normal(size=(B, 2**n)).astype(np.float32))
    # built at the target chi: maxdim == chi caps the polish ranks in the
    # leading block, so no shrink-repad is needed
    W = build_qft_mpo(n, chi=chi, maxdim=chi, dtype=torch.complex64,
                      device=dev)
    psis = batched_signal_mps(xs, chi=chi, cutoff=1e-12, device=dev)
    configs = tensor_int_to_bits(torch.arange(2**n), n, order="lsb",
                                 device=dev)

    # dp-sharded targets and two training steps (the gradient summed over
    # dp) from a perturbed operator: loss0 > 0 and the step must descend
    psis_sharded = shard_batch(mesh, psis)
    targets = shard_batch(mesh, coefficient_batch(apply(W, psis), configs))
    shape = W.cores.shape
    noise = torch.from_numpy(
        (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
            np.complex64)).to(dev)
    W_pert = replicate(mesh, MPO(cores=W.cores + 0.02 * noise,
                                 ranks=W.ranks))
    W_fit, loss0 = fit_mpo_step(W_pert, psis_sharded, configs, targets,
                                lr=2e-3)
    _, loss1 = fit_mpo_step(W_fit, psis_sharded, configs, targets, lr=2e-3)
    loss0, loss1 = float(loss0), float(loss1)
    if not (loss0 > 0.0 and loss1 < loss0):
        raise RuntimeError(f"fit step did not descend: loss0={loss0:.3e} "
                           f"loss1={loss1:.3e}")

    # grid-sharded readout of one state
    one = MPS(cores=psis.cores[0], ranks=psis.ranks[0],
              amplitude=psis.amplitude[0])
    out = apply(W, one, maxdim=chi, cutoff=1e-12)
    pad = (-configs.shape[0]) % n_devices
    cfg = torch.cat([configs, configs.new_zeros(pad, n)])
    vals = sharded_chi_grid(mesh, out, cfg)

    # the flagship-shape sharded search: n=10, chi=64, cross encode, the
    # analytic multi-wr operator stack on dp, the readout grid on grid
    n2 = 10
    N2 = 2**n2
    lam, w0 = 1.0e-3, 0.35
    j2 = np.arange(N2)
    x2 = (np.exp(-lam * j2) * np.sin(w0 * j2)).astype(np.float32)
    psi2 = tighten(signal_ztmps(x2, method="cross", cutoff=1e-10, maxdim=64,
                                device=dev))
    wrs = [2 * math.pi * (1.0 + 0.25 * i) for i in range(mesh.shape["dp"])]
    Ws = stack_mpos([zt_mpo(n2, wr, engine="analytic", cutoff=1e-12,
                            maxdim=64, chi=64, dtype=torch.complex64,
                            cache=False, device=dev) for wr in wrs])
    stride = N2 // 32
    kk = np.arange(32) * stride  # 32 x 32 = 1024 points: divisible by any
    K, L = np.meshgrid(kk, kk, indexing="ij")  # mesh axis size up to 32
    cfg2 = paired_config_from_kl(K.ravel(), L.ravel(), n2, device=dev)
    mag = sharded_multi_scan(mesh, Ws, psi2, cfg2).abs().cpu().numpy()
    l_true = round(w0 * N2 / (2 * math.pi))
    peaks = []
    for op in range(len(wrs)):  # every operator's peak, on its line
        i = int(mag[op].argmax())
        k_pk, l_pk = int(K.ravel()[i]), int(L.ravel()[i])
        l_err = min(abs(l_pk - l_true), abs(l_pk - (N2 - l_true)))
        if not (l_err <= stride and k_pk <= 2 * stride):
            raise RuntimeError(f"operator {op}: scan peak (k={k_pk}, "
                               f"l={l_pk}) off the line l={l_true}")
        peaks.append((k_pk, l_pk))

    print(f"dryrun_multichip: mesh={tuple(mesh.shape.items())} "
          f"loss0={loss0:.3e} -> loss1={loss1:.3e} (descending) "
          f"scan={tuple(vals.shape)} flagship n={n2} chi=64 multi-wr sharded "
          f"scan peaks={peaks} vs line l={l_true} (ok)", flush=True)
    return dict(mesh=mesh.shape, loss0=loss0, loss1=loss1,
                scan_shape=tuple(vals.shape), peaks=peaks, l_line=l_true)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), out.dtype)
