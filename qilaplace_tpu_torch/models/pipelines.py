"""End-to-end transform pipelines.

Counterpart of ``qilaplace_tpu/models/pipelines.py``. Each bundles
encode -> build MPO -> apply -> read out, on ``device`` (the card unless
told otherwise):

* ``QFTPipeline``: spectrum analysis. rsvd or TT-SVD encode, the
  gate-built QFT operator, the zip-up apply, and a readout of the output
  state at chosen frequencies: through kernel K1 (ops/readout_kernels.py)
  where it takes the state, else the plain ``coefficient_batch``;
* ``DTPipeline``: the damping transform on the paired register: the
  gate-built DT operator, the zip-up apply and a plain
  ``coefficient_batch`` readout, as in the JAX package;
* ``ZTPipeline``: the full z-transform with pole identification: cross
  (default, host f64), rsvd or TT-SVD encode, the analytic or gate-built
  operator behind its artifact cache, the zip-up apply, and the direct
  <config|W|psi> readout or the apply-then-read scan.
"""

from __future__ import annotations

import torch

from qilaplace_tpu_torch.core.mps import (
    MPS,
    _chain,
    _rewrap,
    coefficient_batch,
)
from qilaplace_tpu_torch.ops.apply import apply
from qilaplace_tpu_torch.ops.readout_kernels import (
    coefficient_batch_k1,
    k1_takes,
)
from qilaplace_tpu_torch.scan.pole_scan import (
    chi_grid,
    chi_grid_direct,
    coarse_to_fine_pole_search,
    pole_scan,
    tighten,
)
from qilaplace_tpu_torch.signals.cross_encode import signal_ztmps_cross
from qilaplace_tpu_torch.signals.encode import signal_mps, signal_ztmps
from qilaplace_tpu_torch.transforms.dt import build_dt_mpo
from qilaplace_tpu_torch.transforms.qft import build_qft_mpo
from qilaplace_tpu_torch.transforms.zt import zt_mpo
from qilaplace_tpu_torch.utils.bits import (
    tensor_int_to_bits,
    tensor_interleave_bits,
)
from qilaplace_tpu_torch.utils.config import resolve_device


class QFTPipeline:
    """Signal -> frequency-domain MPS -> coefficient readout, on
    ``device``."""

    def __init__(self, n: int, *, chi: int = 64, cutoff: float = 1e-12,
                 build_cutoff: float = 1e-14,
                 dtype: torch.dtype = torch.complex64, device=None):
        self.n = n
        self.chi = chi
        self.cutoff = cutoff
        self.device = resolve_device(device)
        self.mpo = build_qft_mpo(n, cutoff=build_cutoff, dtype=dtype,
                                 device=self.device)

    def encode(self, x, *, method: str = "svd", **kw):
        return signal_mps(x, method=method, cutoff=self.cutoff,
                          maxdim=self.chi, chi=self.chi, device=self.device,
                          **kw)

    def forward(self, psi):
        return apply(self.mpo, psi, maxdim=self.chi, cutoff=self.cutoff)

    def spectrum(self, psi_out, freqs) -> torch.Tensor:
        """Coefficients at integer frequency indices ``freqs`` (natural
        order; the bit reversal is part of the readout configs). Read by
        K1 where it takes the state (``readout_kernels.k1_takes``: a
        complex64 state on the card with chi <= 256); any other state, the
        CPU's among them, by the plain ``coefficient_batch`` in its own
        dtype, as the JAX package reads."""
        m = _chain(psi_out)
        configs = tensor_int_to_bits(freqs, self.n, order="lsb",
                                     device=m.device)
        configs = configs.to(torch.int32).contiguous()
        if not k1_takes(m.cores.device, m.dtype, m.chi, m.amplitude):
            return coefficient_batch(psi_out, configs)
        chain = MPS(cores=m.cores.contiguous(), ranks=m.ranks,
                    amplitude=m.amplitude)
        return coefficient_batch_k1(_rewrap(psi_out, chain), configs)

    def __call__(self, x, freqs):
        return self.spectrum(self.forward(self.encode(x)), freqs)


class DTPipeline:
    """Paired-register damping transform, on ``device``."""

    def __init__(self, n: int, wr: float, *, chi: int = 64,
                 cutoff: float = 1e-12, build_cutoff: float = 1e-14,
                 dtype: torch.dtype = torch.complex64, device=None):
        self.n = n
        self.wr = wr
        self.chi = chi
        self.cutoff = cutoff
        self.device = resolve_device(device)
        self.mpo = build_dt_mpo(n, wr, cutoff=build_cutoff, dtype=dtype,
                                device=self.device)

    def encode(self, x, **kw):
        return signal_ztmps(x, cutoff=self.cutoff, maxdim=self.chi,
                            chi=self.chi, device=self.device, **kw)

    def forward(self, psi_z):
        return apply(self.mpo, psi_z, maxdim=self.chi, cutoff=self.cutoff)

    def coefficients(self, psi_out, ks, js) -> torch.Tensor:
        """Damped coefficients at main-register index k, copy-register j:
        the main register holds k LSB-first, the copy register still
        carries the input index j MSB-first."""
        device = _chain(psi_out).device
        kb = tensor_int_to_bits(ks, self.n, order="lsb", device=device)
        jb = tensor_int_to_bits(js, self.n, order="msb", device=device)
        return coefficient_batch(psi_out, tensor_interleave_bits(kb, jb))


class ZTPipeline:
    """Full z-transform with pole identification, on ``device``."""

    def __init__(self, n: int, *, chi: int = 128, cutoff: float = 1e-12,
                 build_cutoff: float = 1e-12,
                 dtype: torch.dtype = torch.complex64,
                 engine: str = "analytic", readout: str = "auto",
                 cache: bool = True, cache_dir: str | None = None,
                 device=None):
        self.n = n
        self.chi = chi
        self.cutoff = cutoff
        self.build_cutoff = build_cutoff
        self.dtype = dtype
        self.engine = engine
        self.readout = readout
        self.cache = cache
        self.cache_dir = cache_dir
        self.device = resolve_device(device)
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
        if method == "cross":
            return signal_ztmps_cross(x, cutoff=self.cutoff,
                                      maxdim=min(self.chi, 256), chi=self.chi,
                                      device=self.device, **kw)
        if method == "rsvd":
            kw.setdefault("k", 50)
            kw.setdefault("p", 5)
            kw.setdefault("q", 2)
        return signal_ztmps(x, method=method, cutoff=self.cutoff,
                            maxdim=self.chi, chi=self.chi,
                            device=self.device, **kw)

    def forward(self, psi_z, wr: float):
        return apply(self.mpo(wr), psi_z, maxdim=self.chi, cutoff=self.cutoff)

    def chi_grid(self, psi_out, ks, ls):
        """Grid of a product state ``forward(psi_z, wr)``."""
        return chi_grid(psi_out, ks, ls)

    def chi_grid_direct(self, psi_z, ks, ls, *, wr):
        """Direct <config|W|psi> grid; no intermediate product state."""
        return chi_grid_direct(tighten(self.mpo(wr)), tighten(psi_z), ks, ls)

    def scan(self, psi_out, ks, ls, *, wr):
        """Peak of a product state's grid (:func:`pole_scan`)."""
        return pole_scan(psi_out, ks, ls, wr=wr)

    def find_poles(self, psi_z, **kw):
        kw.setdefault("cutoff", self.build_cutoff)
        kw.setdefault("maxdim", self.chi)
        kw.setdefault("engine", self.engine)
        kw.setdefault("readout", self.readout)
        kw.setdefault("cache", self.cache)
        kw.setdefault("cache_dir", self.cache_dir)
        return coarse_to_fine_pole_search(psi_z, **kw)
