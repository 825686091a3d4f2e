"""Entry ``qft_spectrum``: one signal a request through ``QFTPipeline``:
``encode`` -> ``forward`` -> ``spectrum``.

Set-up builds the pipeline (the QFT operator) once and draws the read
frequencies from the seed. Each request's signal x_j = sin(c j / N), c a
whole number drawn from the seed in ``c_range``, is made on the card
before the request starts (outside its latency); the request encodes it
with the configuration's encoder, applies the operator and reads the
frequencies. Every request's spectrum is kept and held against the closed
form after the window.

Mix keys: entry, c_range, frequencies, limits. Config keys: n, chi, cutoff,
build_cutoff, dtype, encode.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from portbench.harness import reference, signals


class Entry:
    def __init__(self, ctx):
        import qilaplace_tpu_torch as qt

        cfg, mix = ctx.config, ctx.mix
        self.ctx, self.n = ctx, cfg["n"]
        self.encode_kw = dict(cfg["encode"])
        self.pipe = qt.QFTPipeline(
            self.n, chi=cfg["chi"], cutoff=cfg["cutoff"],
            build_cutoff=cfg["build_cutoff"],
            dtype=getattr(torch, cfg["dtype"]), device=ctx.device)
        self.freqs = torch.from_numpy(signals.qft_freqs(
            self.n, np.random.default_rng([ctx.seed, 0]),
            mix["frequencies"])).to(ctx.device)
        self.draws = np.random.default_rng([ctx.seed, 1])
        self.kept = []
        self.c = 1
        self.x = signals.sin_on_card(self.n, [self.c], ctx.device)[0]
        self.request(-1)  # warm-up
        self.kept.clear()
        ctx.sync()

    def prepare(self, i):
        lo, hi = self.ctx.mix["c_range"]
        self.c = int(self.draws.integers(lo, hi + 1))
        self.x = None
        self.x = signals.sin_on_card(self.n, [self.c], self.ctx.device)[0]

    def request(self, i):
        with self.ctx.span("encode"):
            psi = self.pipe.encode(self.x, **self.encode_kw)
        with self.ctx.span("forward"):
            out = self.pipe.forward(psi)
        with self.ctx.span("spectrum"):
            got = self.pipe.spectrum(out, self.freqs)
        self.kept.append((self.c, got))
        return 1.0

    def release(self):
        del self.pipe, self.x

    def check(self) -> dict:
        """The widest gap of a spectrum to the closed form, relative to its
        largest value, over every request."""
        worst = max(reference.err_rel_peak(
            got, reference.sin_dft(self.n, self.freqs, c))
            for c, got in self.kept)
        return {"qft_err_rel_peak": (worst, self.ctx.mix["limits"]
                                     ["qft_err_rel_peak"])}

    def counters(self) -> dict:
        from qilaplace_tpu_torch.ops.jacobi_kernels import jacobi_eigh_k2

        return {"k2_launches": jacobi_eigh_k2.launches,
                "k2_by_shape": collections.Counter(jacobi_eigh_k2.by_shape)}

    def trace_hooks(self) -> dict:
        """Host spans around the program's encode, apply and readout
        steps."""
        from qilaplace_tpu_torch.core import mps
        from qilaplace_tpu_torch.ops import apply, readout_kernels, rsvd
        from qilaplace_tpu_torch.signals import encode

        wrap = self.ctx.spans.wrapped
        fns = {"rsvd": rsvd.rsvd, "tt_rsvd": encode._tt_rsvd,
               "tt_svd": encode._tt_svd, "apply_fused": apply._apply_fused,
               "K1": readout_kernels.coefficient_batch_k1,
               "coefficient_batch": mps.coefficient_batch}
        return {fn: wrap(name, fn) for name, fn in fns.items()}
