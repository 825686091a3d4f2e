"""Entry ``zt_poles``: the reference's pole search from raw samples through
``ZTPipeline.encode`` and ``ZTPipeline.find_poles``.

Set-up builds the pipeline with the configuration's readout and reads its
two operators once through ``ZTPipeline.mpo`` (at the configuration's
``wr`` and the mix's ``wr_fine``; their artifact cache in
``ctx.cache_dir``, the keys of the ``zt_grid`` entry's operators), draws
``pool`` parameter sets of the mix's family from the seed, allocates one
float32 sample buffer of 2^n on the device, and warms up with one request.
Each request's parameters are drawn from the seed and its 2^n samples
written into that buffer on the device before it starts (outside its
latency). The request encodes them with the configuration's encoder and
runs ``find_poles`` with the mix's grid sizes: the coarse plane at ``wr``,
the fine window and the superfine window at ``wr_fine``. Its units are the
points of the three grids. ``check_share`` of the requests, drawn from the
seed, are kept; after the window every point of their grids is held
against the float64 closed form, relative to the signal's peak, and the
superfine peak against the closed form's argmax over the same window, in
grid steps.

Mix keys: entry, family, pool, coarse_points, fine_points, superfine_half,
wr_fine, check_share, limits. Config keys: n, wr, chi, cutoff,
build_cutoff, dtype, state_dtype, engine, readout, encode.
"""

from __future__ import annotations

import collections
import sys
import time

import numpy as np
import torch

from portbench.harness import reference, signals
from portbench.harness.yardstick import live_widths


def damped_sines_into(out: torch.Tensor, terms, chunk: int = 1 << 26):
    """x_j = sum_t a_t sin(w_t j / N) e^{-g_t j / N} into ``out`` [N],
    evaluated in float64 on its device a chunk at a time."""
    N = out.shape[0]
    for lo in range(0, N, chunk):
        j = torch.arange(lo, min(N, lo + chunk), dtype=torch.float64,
                         device=out.device)
        acc = torch.zeros_like(j)
        for a, w, g in terms:
            acc += a * torch.sin(w * j / N) * torch.exp(-g * j / N)
        out[lo:lo + j.numel()] = acc


def grid_steps(a: int, b: int, N: int) -> int:
    """Steps between two column indices on the periodic l axis."""
    d = abs(a - b) % N
    return min(d, N - d)


class Entry:
    def __init__(self, ctx):
        import qilaplace_tpu_torch as qt

        cfg, mix = ctx.config, ctx.mix
        self.ctx, self.n, self.wr = ctx, cfg["n"], cfg["wr"]
        self.encode_kw = dict(cfg["encode"])
        t0 = time.perf_counter()
        self.pipe = qt.ZTPipeline(
            self.n, chi=cfg["chi"], cutoff=cfg["cutoff"],
            build_cutoff=cfg["build_cutoff"],
            dtype=getattr(torch, cfg["dtype"]), engine=cfg["engine"],
            readout=cfg["readout"], cache=True, cache_dir=ctx.cache_dir,
            device=ctx.device)
        for wr in (self.wr, mix["wr_fine"]):
            self.pipe.mpo(wr)
        ctx.sync()
        t1 = time.perf_counter()
        rng = np.random.default_rng([ctx.seed, 0])
        self.terms = [signals.damped_sines(mix["family"], rng)
                      for _ in range(mix["pool"])]
        self.x = torch.empty(2**self.n, device=ctx.device,
                             dtype=getattr(torch, cfg["state_dtype"]))
        self.draws = np.random.default_rng([ctx.seed, 1])
        self.picks = np.random.default_rng([ctx.seed, 2])
        self.kept, self.k1_calls = [], []
        self.p = 0
        damped_sines_into(self.x, self.terms[0])
        self.request(-1)  # warm-up: one request's shapes
        self.kept.clear()
        ctx.sync()
        print(f"portbench: set-up operators {t1 - t0:.3f} s, warm-up "
              f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)

    def prepare(self, i):
        self.p = int(self.draws.integers(len(self.terms)))
        damped_sines_into(self.x, self.terms[self.p])

    def request(self, i):
        mix, span = self.ctx.mix, self.ctx.span
        with span("encode"):
            psi = self.pipe.encode(self.x, **self.encode_kw)
        with span("search"):
            res = self.pipe.find_poles(
                psi, wr_coarse=self.wr, wr_fine=mix["wr_fine"],
                coarse_points=mix["coarse_points"],
                fine_points=mix["fine_points"],
                superfine_half=mix["superfine_half"])
        grids = [(st.wr, st.ks, st.ls, st.chi)
                 for st in (res.coarse, res.fine, res.superfine)]
        if self.picks.random() < mix["check_share"]:
            self.kept.append((self.p, grids, (res.superfine.k_peak,
                                              res.superfine.l_peak)))
        return float(sum(chi.numel() for *_, chi in grids))

    def release(self):
        del self.pipe, self.x

    def check(self) -> dict:
        """The widest gap of a kept grid to the closed form, relative to the
        largest |chi| of its signal; and the widest distance, in grid steps
        along k or l, of a superfine peak from the closed form's argmax
        over the same window."""
        worst, steps = 0.0, 0
        peaks = {}
        N = 2**self.n
        for p, grids, (k_peak, l_peak) in self.kept:
            if p not in peaks:
                peaks[p] = reference.zt_peak(self.n, self.terms[p],
                                             wr=self.wr,
                                             device=grids[0][1].device)
            for wr, ks, ls, chi in grids:
                K, L = torch.meshgrid(ks, ls, indexing="ij")
                want = reference.zt_grid(self.n, K.reshape(-1),
                                         L.reshape(-1), self.terms[p], wr=wr)
                worst = max(worst, reference.err_rel_peak(
                    chi.reshape(-1), want, peaks[p]))
            at = int(want.abs().argmax())  # the superfine window's
            k_want, l_want = int(K.reshape(-1)[at]), int(L.reshape(-1)[at])
            steps = max(steps, abs(int(k_peak) - k_want),
                        grid_steps(int(l_peak), l_want, N))
        limits = self.ctx.mix["limits"]
        return {"zt_err_rel_peak": (worst, limits["zt_err_rel_peak"]),
                "superfine_peak_steps": (float(steps),
                                         limits["superfine_peak_steps"])}

    def counters(self) -> dict:
        """K2's launches by shape, K1's launches (rows, sites and live
        widths), and the operators the program built or read from disk
        (counters a program without them does not report)."""
        from qilaplace_tpu_torch.ops.jacobi_kernels import jacobi_eigh_k2
        from qilaplace_tpu_torch.transforms import zt

        out = {"k1_calls": list(self.k1_calls),
               "k2_launches": jacobi_eigh_k2.launches,
               "k2_by_shape": collections.Counter(jacobi_eigh_k2.by_shape)}
        for what in ("loads", "builds"):
            count = getattr(zt.zt_mpo, what, None)
            if count is not None:
                out["operator_" + what] = count
        return out

    def trace_hooks(self) -> dict:
        """Host spans around the program's steps: the encoder's, the
        operator build or load, the zip-up apply (synchronised, so that it
        holds its device work) and the readout; and a record of every K1
        launch's rows, sites and live widths, as the ``zt_grid`` entry
        keeps."""
        from qilaplace_tpu_torch.ops import apply, readout_kernels, rsvd
        from qilaplace_tpu_torch.scan import pole_scan
        from qilaplace_tpu_torch.signals import encode
        from qilaplace_tpu_torch.transforms import zt

        k1 = readout_kernels.coefficient_batch_k1

        def record(out, args):
            chain, configs = getattr(args[0], "chain", args[0]), args[1]
            if chain.cores.is_cuda:
                self.k1_calls.append((int(configs.shape[0]), chain.n,
                                      live_widths(chain.cores)))

        wrap = self.ctx.spans.wrapped
        fns = {"rsvd": rsvd.rsvd, "tt_rsvd": encode._tt_rsvd,
               "zt_mpo": zt.zt_mpo, "pole_scan": pole_scan.pole_scan}
        hooks = {fn: wrap(name, fn) for name, fn in fns.items()}
        hooks[k1] = wrap("K1", k1, record)
        hooks[apply._apply_fused] = wrap(
            "apply_fused", apply._apply_fused,
            lambda out, args: self.ctx.sync())
        return hooks
