"""End-to-end zT pipeline.

Counterpart of ``qilaplace_tpu/models/pipelines.py`` (``ZTPipeline``
only): cross-interpolation encode in host f64, the analytic operator
behind its artifact cache, and the direct <config|W|psi> readout.
"""

from __future__ import annotations

import torch

from qilaplace_tpu_torch.scan.pole_scan import (
    chi_grid_direct,
    coarse_to_fine_pole_search,
    tighten,
)
from qilaplace_tpu_torch.signals.cross_encode import signal_ztmps_cross
from qilaplace_tpu_torch.transforms.zt import zt_mpo


class ZTPipeline:
    """Full z-transform with pole identification, on ``device``."""

    def __init__(self, n: int, *, chi: int = 128, cutoff: float = 1e-12,
                 build_cutoff: float = 1e-12,
                 dtype: torch.dtype = torch.complex64,
                 engine: str = "analytic", readout: str = "auto",
                 cache: bool = True, cache_dir: str | None = None,
                 device="cpu"):
        self.n = n
        self.chi = chi
        self.cutoff = cutoff
        self.build_cutoff = build_cutoff
        self.dtype = dtype
        self.engine = engine
        self.readout = readout
        self.cache = cache
        self.cache_dir = cache_dir
        self.device = device
        self._mpo_cache: dict = {}

    def mpo(self, wr: float):
        if wr not in self._mpo_cache:
            self._mpo_cache[wr] = zt_mpo(
                self.n, wr, engine=self.engine, cutoff=self.build_cutoff,
                maxdim=self.chi, chi=self.chi, dtype=self.dtype,
                cache=self.cache, cache_dir=self.cache_dir,
                device=self.device,
            )
        return self._mpo_cache[wr]

    def encode(self, x, *, method: str = "cross", **kw):
        if method != "cross":
            raise NotImplementedError(
                f"ZTPipeline.encode: method {method!r} is not ported yet "
                "(ROADMAP queue 1, item 9: signals + device encoders)"
            )
        return signal_ztmps_cross(x, cutoff=self.cutoff,
                                  maxdim=min(self.chi, 256), chi=self.chi,
                                  device=self.device, **kw)

    def chi_grid_direct(self, psi_z, ks, ls, *, wr):
        """Direct <config|W|psi> grid; no intermediate product state."""
        return chi_grid_direct(tighten(self.mpo(wr)), tighten(psi_z), ks, ls)

    def find_poles(self, psi_z, **kw):
        kw.setdefault("cutoff", self.build_cutoff)
        kw.setdefault("maxdim", self.chi)
        kw.setdefault("engine", self.engine)
        kw.setdefault("readout", self.readout)
        kw.setdefault("cache", self.cache)
        kw.setdefault("cache_dir", self.cache_dir)
        return coarse_to_fine_pole_search(psi_z, **kw)
