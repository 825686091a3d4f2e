"""Entry ``zt_grid``: the z-plane grids of a pole search through
``ZTPipeline.chi_grid_direct``.

Set-up builds the two zT operators of a pole search once through
``ZTPipeline.mpo`` (at the configuration's ``wr`` and the mix's
``wr_fine``; their artifact cache in ``ctx.cache_dir``, so that a
checkout's first run builds them and later runs load them) and
cross-encodes a pool of ``pool`` signals of the mix's family, their
parameters drawn from the seed. Each request is one pool state, drawn from
the seed, read on the three grids that ``coarse_to_fine_pole_search``
reads, with its default sizes in the mix: the full plane at stride
N / ``coarse_points`` at ``wr``; a window of about ``fine_points`` x
``fine_points`` around the coarse peak at ``wr_fine``; a stride-1 window of
half-width ``superfine_half`` around the fine peak at ``wr_fine``. Each
peak is the argmax of |chi| over the program's own grid, read to the host
as the search reads it. The window arithmetic is frozen here from the
search. ``check_share`` of the requests, drawn from the seed, are kept and
every point of their grids is held against the closed form after the
window.

Mix keys: entry, family, pool, coarse_points, fine_points, superfine_half,
wr_fine, check_share, limits. Config keys: n, wr, chi, cutoff,
build_cutoff, dtype, state_dtype, engine, readout.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from portbench.harness import reference, signals
from portbench.harness.yardstick import live_widths

TWO_PI = 2.0 * math.pi


def z_from_kl(k: int, l: int, n: int, wr: float) -> complex:
    """Grid indices -> z = e^{-(wr k + i 2 pi l) / N}, in float64."""
    N = 2**n
    r = math.exp(-wr * k / N)
    theta = TWO_PI * l / N
    return complex(r * math.cos(theta), -r * math.sin(theta))


def kl_from_z(z: complex, n: int, wr: float) -> tuple[int, int]:
    """The nearest grid indices at ``wr`` of a z-plane point."""
    N = 2**n
    theta = (-math.atan2(z.imag, z.real)) % TWO_PI
    k = min(max(round(-N * math.log(abs(z)) / wr), 0), N - 1)
    return k, round(N * theta / TWO_PI) % N


def peak(vals: torch.Tensor, ks: torch.Tensor, ls: torch.Tensor):
    """(k, l) of a grid's largest |chi|, read to the host."""
    flat = int(torch.argmax(vals.abs()))
    return int(ks[flat // vals.shape[1]]), int(ls[flat % vals.shape[1]])


class Entry:
    def __init__(self, ctx):
        import qilaplace_tpu_torch as qt

        cfg, mix = ctx.config, ctx.mix
        self.ctx, self.n, self.wr = ctx, cfg["n"], cfg["wr"]
        self.wr_fine = mix["wr_fine"]
        t0 = time.perf_counter()
        self.pipe = qt.ZTPipeline(
            self.n, chi=cfg["chi"], cutoff=cfg["cutoff"],
            build_cutoff=cfg["build_cutoff"],
            dtype=getattr(torch, cfg["dtype"]), engine=cfg["engine"],
            readout=cfg["readout"], cache=True, cache_dir=ctx.cache_dir,
            device=ctx.device)
        for wr in (self.wr, self.wr_fine):
            self.pipe.mpo(wr)
        ctx.sync()
        t1 = time.perf_counter()
        rng = np.random.default_rng([ctx.seed, 0])
        self.terms = [signals.damped_sines(mix["family"], rng)
                      for _ in range(mix["pool"])]
        state_dtype = getattr(torch, cfg["state_dtype"])
        self.pool = [self.pipe.encode(signals.sample_fn(self.n, t))
                     .to(dtype=state_dtype) for t in self.terms]
        ctx.sync()
        t2 = time.perf_counter()
        self.draws = np.random.default_rng([ctx.seed, 1])
        self.picks = np.random.default_rng([ctx.seed, 2])
        self.kept, self.k1_calls = [], []
        self.search(self.pool[0])  # warm-up: one request's shapes
        ctx.sync()
        print(f"portbench: set-up operators {t1 - t0:.3f} s, encodes "
              f"{t2 - t1:.3f} s, warm-up {time.perf_counter() - t2:.3f} s",
              file=sys.stderr)

    def _arange(self, lo, hi, step=1):
        return torch.arange(lo, hi, step, dtype=torch.int64,
                            device=self.ctx.device)

    def search(self, psi) -> list:
        """The three grids of one pole search on ``psi``:
        [(wr, ks, ls, vals), ...]."""
        mix, n, span = self.ctx.mix, self.n, self.ctx.span
        N = 2**n
        out = []

        def read(name, wr, ks, ls):
            with span(name):
                vals = self.pipe.chi_grid_direct(psi, ks, ls, wr=wr)
            out.append((wr, ks, ls, vals))
            with span(name + "_peak"):
                return peak(vals, ks, ls)

        stride_c = max(1, N // mix["coarse_points"])
        ks_c = self._arange(0, N, stride_c)
        k, l = read("coarse", self.wr, ks_c, ks_c)
        k_c, l_c = kl_from_z(z_from_kl(k, l, n, self.wr), n, self.wr_fine)
        half_k = max(1, round(stride_c * self.wr / self.wr_fine))
        half_l = max(1, stride_c)
        stride_fk = max(1, (2 * half_k) // mix["fine_points"])
        stride_fl = max(1, (2 * half_l) // mix["fine_points"])
        ks_f = torch.clamp(k_c + self._arange(-half_k, half_k + 1, stride_fk),
                           0, N - 1)
        ls_f = torch.remainder(
            l_c + self._arange(-half_l, half_l + 1, stride_fl), N)
        k_f, l_f = read("fine", self.wr_fine, ks_f, ls_f)
        h = mix["superfine_half"]
        ks_s = torch.clamp(k_f + self._arange(-h, h + 1), 0, N - 1)
        ls_s = torch.remainder(l_f + self._arange(-h, h + 1), N)
        read("superfine", self.wr_fine, ks_s, ls_s)
        return out

    def prepare(self, i):
        self.p = int(self.draws.integers(len(self.pool)))

    def request(self, i):
        grids = self.search(self.pool[self.p])
        if self.picks.random() < self.ctx.mix["check_share"]:
            self.kept.append((self.p, grids))
        return float(sum(vals.numel() for *_, vals in grids))

    def release(self):
        del self.pipe, self.pool

    def check(self) -> dict:
        """The widest gap of a kept grid to the closed form, relative to the
        largest |chi| of its signal (at the signal's poles, the same at
        every wr; a window need not hold them, and its own largest value
        can lie far below)."""
        worst = 0.0
        peaks = {}
        for p, grids in self.kept:
            if p not in peaks:
                peaks[p] = reference.zt_peak(self.n, self.terms[p],
                                             wr=self.wr,
                                             device=grids[0][1].device)
            for wr, ks, ls, vals in grids:
                K, L = torch.meshgrid(ks, ls, indexing="ij")
                want = reference.zt_grid(self.n, K.reshape(-1),
                                         L.reshape(-1), self.terms[p], wr=wr)
                worst = max(worst, reference.err_rel_peak(
                    vals.reshape(-1), want, peaks[p]))
        return {"zt_err_rel_peak": (worst, self.ctx.mix["limits"]
                                    ["zt_err_rel_peak"])}

    def counters(self) -> dict:
        return {"k1_calls": list(self.k1_calls)}

    def trace_hooks(self) -> dict:
        """Host spans around the program's steps of a grid read, and a
        record of every K1 launch's rows, sites and live widths."""
        from qilaplace_tpu_torch.ops import apply, readout_kernels
        from qilaplace_tpu_torch.scan import pole_scan

        k1 = readout_kernels.coefficient_batch_k1

        def record(out, args):
            chain, configs = getattr(args[0], "chain", args[0]), args[1]
            if chain.cores.is_cuda:
                self.k1_calls.append((int(configs.shape[0]), chain.n,
                                      live_widths(chain.cores)))

        wrap = self.ctx.spans.wrapped
        return {k1: wrap("K1", k1, record),
                pole_scan.tighten: wrap("tighten", pole_scan.tighten),
                pole_scan._grid_configs: wrap("grid_configs",
                                              pole_scan._grid_configs),
                apply.zipper_chain: wrap("zipper_chain", apply.zipper_chain),
                apply.apply_coefficient_batch: wrap(
                    "apply_coefficient_batch", apply.apply_coefficient_batch),
                readout_kernels.pack_live_lanes: wrap(
                    "pack_live_lanes", readout_kernels.pack_live_lanes)}
