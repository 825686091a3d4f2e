"""Pole-scan API: readout grids and the coarse-to-fine pole search.

Counterpart of ``qilaplace_tpu/scan/pole_scan.py``. Two readout routes:

* direct (``chi_grid_direct``): ``<config| W |psi>`` per grid point. A
  chain that K1 takes (``readout_kernels.k1_takes``: on the card, the
  effective chain of chi_eff = chi_W * chi_psi <= 256 in complex64 with a
  real amplitude) is folded by ``zipper_chain`` and read by kernel K1;
  every other pair on the card (complex128, or wider) takes the factored
  ``apply_coefficient_batch`` in its own dtype, as the JAX package's
  ``_direct_vals`` does off its Pallas route. On the CPU the route is by
  width alone: chi_eff <= 256 takes ``zipper_chain`` and K1's plain
  version. Both routes compute the same numbers.
* apply-then-read (``chi_grid``, ``pole_scan``): the product state
  ``apply(W, psi)`` is formed once per transform and read at every grid
  point. A state that K1 takes goes to K1 (the counterpart of the JAX
  package's "TPU and fits VMEM" Pallas route); every other state takes
  the plain ``coefficient_batch``.

Coordinate conventions: s(k, l) = (wr k + i wi l) / N, z(k, l) = e^{-s(k, l)},
chi(k, l) read out at interleaved LSB-first (k, l) bits. ``z_from_kl`` and
``kl_from_z`` always compute in float64 (N = 2^n reaches 2^30).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from qilaplace_tpu_torch.core.mps import MPS, ZTMPS, coefficient_batch
from qilaplace_tpu_torch.ops.apply import (
    apply,
    apply_coefficient_batch,
    zipper_chain,
)
from qilaplace_tpu_torch.ops.readout_kernels import (
    MAX_CHI,
    coefficient_batch_k1,
    k1_takes,
)
from qilaplace_tpu_torch.transforms.zt import zt_mpo
from qilaplace_tpu_torch.utils.bits import paired_config_from_kl
from qilaplace_tpu_torch.utils.config import real_dtype

TWO_PI = 2.0 * math.pi


def direct_vals(W, psi, configs) -> torch.Tensor:
    """Direct <config|W|psi> values at int32 ``configs`` [B, 2n] on psi's
    device (the JAX package's ``_direct_vals``): the effective chain of
    ``zipper_chain`` through K1 where K1 takes it, else the factored
    ``apply_coefficient_batch`` in the pair's own dtype; on the CPU, every
    pair with chi_eff = chi_W * chi_psi <= 256 takes the effective chain
    and K1's plain version."""
    chain = psi.chain
    chi_eff = W.chain.chi * chain.chi
    dtype = torch.promote_types(W.chain.dtype, chain.dtype)
    if chi_eff <= MAX_CHI and (chain.cores.device.type == "cpu" or k1_takes(
            chain.cores.device, dtype, chi_eff, chain.amplitude)):
        return coefficient_batch_k1(zipper_chain(W, psi), configs)
    return apply_coefficient_batch(W, psi, configs)


def _grid_configs(n: int, ks: torch.Tensor, ls: torch.Tensor):
    """int32 [len(ks) len(ls), 2n] readout configs of the ks x ls grid."""
    K, L = torch.meshgrid(ks, ls, indexing="ij")
    return paired_config_from_kl(K.reshape(-1), L.reshape(-1), n)


def chi_grid(psi_out: ZTMPS, ks, ls, *,
             use_kernel: bool | None = None) -> torch.Tensor:
    """Sample chi on the outer product of index vectors ``ks`` x ``ls``
    from a product state ``psi_out = apply(W, psi)``; returns a
    [len(ks), len(ls)] complex grid on the state's device.

    ``use_kernel=None`` (default) reads through K1 whenever it takes the
    state (``readout_kernels.k1_takes``: what the JAX package's Pallas
    route asks of its TPU, a backend that runs the kernel and a core stack
    that fits); True sends it to K1's wrapper (the plain version for a CPU
    state), False to the plain ``coefficient_batch``."""
    chain = psi_out.chain
    device = chain.device
    ks = torch.as_tensor(ks, dtype=torch.int64, device=device)
    ls = torch.as_tensor(ls, dtype=torch.int64, device=device)
    configs = _grid_configs(psi_out.n, ks, ls)
    if use_kernel is None:
        use_kernel = k1_takes(chain.cores.device, chain.dtype, chain.chi,
                              chain.amplitude)
    if use_kernel:
        vals = coefficient_batch_k1(
            MPS(cores=chain.cores.contiguous(), ranks=chain.ranks,
                amplitude=chain.amplitude), configs.contiguous())
    else:
        vals = coefficient_batch(chain, configs)
    return vals.reshape(ks.shape[0], ls.shape[0])


def chi_grid_direct(W, psi_z: ZTMPS, ks, ls) -> torch.Tensor:
    """Sample chi on ``ks`` x ``ls`` by direct ``<config| W |psi>``
    contraction (no intermediate truncated product state); returns a
    [len(ks), len(ls)] complex grid on psi's device."""
    device = psi_z.chain.device
    ks = torch.as_tensor(ks, dtype=torch.int64, device=device)
    ls = torch.as_tensor(ls, dtype=torch.int64, device=device)
    vals = direct_vals(W, psi_z, _grid_configs(psi_z.n, ks, ls))
    return vals.reshape(ks.shape[0], ls.shape[0])


def z_from_kl(k, l, n: int, wr, wi=TWO_PI) -> torch.Tensor:
    """Grid indices -> z-plane point z = r e^{-i theta} (complex128)."""
    N = 2**n
    k = torch.as_tensor(k, dtype=torch.float64)
    l = torch.as_tensor(l, dtype=torch.float64, device=k.device)
    r = torch.exp(-wr * k / N)
    theta = wi * l / N
    return torch.complex(r * torch.cos(theta), -r * torch.sin(theta))


def kl_from_z(z, n: int, wr, wi=TWO_PI):
    """Nearest grid indices (int64) for a z-plane target."""
    N = 2**n
    z = torch.as_tensor(z, dtype=torch.complex128)
    r = z.abs()
    theta = torch.remainder(-torch.angle(z), TWO_PI)
    k = torch.clamp(torch.round(-N * torch.log(r) / wr).long(), 0, N - 1)
    l = torch.remainder(torch.round(N * theta / wi).long(), N)
    return k, l


@dataclasses.dataclass
class ScanResult:
    ks: torch.Tensor       # [K] row indices
    ls: torch.Tensor       # [L] column indices
    chi: torch.Tensor      # [K, L] sampled coefficients
    k_peak: torch.Tensor   # argmax |chi| row index
    l_peak: torch.Tensor   # argmax |chi| col index
    z_peak: torch.Tensor   # z at the peak
    wr: float
    wi: float


def _peak(chi: torch.Tensor, ks, ls, n: int, wr, wi) -> ScanResult:
    """The ScanResult of a sampled grid: its argmax |chi| and z there."""
    flat = torch.argmax(chi.abs())
    i, j = flat // chi.shape[1], flat % chi.shape[1]
    return ScanResult(
        ks=ks, ls=ls, chi=chi, k_peak=ks[i], l_peak=ls[j],
        z_peak=z_from_kl(ks[i].cpu(), ls[j].cpu(), n, wr, wi),
        wr=float(wr), wi=float(wi),
    )


def pole_scan(psi_out: ZTMPS, ks, ls, *, wr, wi=TWO_PI) -> ScanResult:
    """Evaluate |chi| on a (k, l) grid of a product state and report the
    peak."""
    device = psi_out.chain.device
    ks = torch.as_tensor(ks, dtype=torch.int64, device=device)
    ls = torch.as_tensor(ls, dtype=torch.int64, device=device)
    return _peak(chi_grid(psi_out, ks, ls), ks, ls, psi_out.n, wr, wi)


def operator_dtype(psi_z: ZTMPS) -> torch.dtype:
    """The dtype of the operators a pole search of ``psi_z`` builds:
    complex128 for a 64-bit state (real part's width), else complex64."""
    wide = real_dtype(psi_z.chain.dtype).itemsize >= 8
    return torch.complex128 if wide else torch.complex64


@dataclasses.dataclass
class PoleSearchResult:
    coarse: ScanResult
    fine: ScanResult
    superfine: ScanResult

    @property
    def z_pole(self) -> torch.Tensor:
        return self.superfine.z_peak


def _tight_bucket(ranks, chi: int) -> int:
    """Smallest bucket holding the realized ranks: multiples of 8, plus a
    4-bucket for the very-low-rank states the cross encoder produces on
    closed-form signals."""
    r = int(ranks.max())
    if r <= 4:
        return min(chi, 4)
    return min(chi, max(8, ((r + 7) // 8) * 8))


def tighten(state):
    """Repad a container to the tight chi bucket for its realized ranks."""
    from qilaplace_tpu_torch.core.mpo import MPO, PairedSiteMPO, mpo_repad
    from qilaplace_tpu_torch.core.mps import repad

    chain = getattr(state, "chain", state)
    chi = _tight_bucket(chain.ranks, chain.chi)
    if chi == chain.chi:
        return state
    if isinstance(state, (MPO, PairedSiteMPO)):
        return mpo_repad(state, chi)
    return repad(state, chi)


def coarse_to_fine_pole_search(
    psi_z: ZTMPS,
    *,
    wr_coarse: float = TWO_PI,
    wr_fine: float = 0.5,
    wi: float = TWO_PI,
    coarse_points: int = 256,
    fine_points: int = 128,
    superfine_half: int = 24,
    cutoff: float = 1e-12,
    maxdim: int = 128,
    apply_fused: bool = True,
    readout: str = "auto",
    engine: str = "analytic",
    cache: bool = True,
    cache_dir: str | None = None,
    operators=None,
) -> PoleSearchResult:
    """Coarse -> fine -> superfine pole identification on psi's device.

    coarse:    stride N/coarse_points over the full (k, l) grid at wr_coarse;
    fine:      rebuild the zT MPO at wr_fine, scan a window around the
               coarse peak;
    superfine: stride-1 window of half-width ``superfine_half`` around the
               fine peak, reusing the fine transform.

    ``engine`` builds each transform ("analytic": the rail-cross route;
    "gate": the gate-layer fold) at ``cutoff`` and ``maxdim``;
    ``cache=True`` loads and saves per-wr operator artifacts. Either
    readout takes each operator tightened to its realized ranks
    (:func:`tighten`), so that its bond padding sets no width of the work.
    ``operators``, a callable wr -> W, hands the search operators built
    and tightened elsewhere (``ZTPipeline.find_poles`` passes the ones it
    keeps in memory) in place of that build or load; they must be what
    those settings build.
    ``readout="direct"`` contracts <config| W |psi> per grid point
    (roundoff relative to the path product);
    ``readout="apply"`` forms the product state once per transform
    (``apply_fused``: the zip-up apply at ``maxdim``/``cutoff``, else the
    exact apply) and reads it (:func:`pole_scan`), with a floor at
    eps ||W psi|| / peak. ``"auto"`` resolves to "direct" for 32-bit states
    and to "apply" for 64-bit ones, as in the JAX package. The width is the
    real part's: a complex64 state is 32-bit and reads directly in
    complex64. This departs from the JAX package, whose rule,
    ``itemsize >= 8``, counts complex64 as 64-bit and applies complex128
    operators to it (with x64 on); both routes find the same peaks
    (``tests/port/test_torch_slice.py``).
    """
    n = psi_z.n
    N = 2**n
    device = psi_z.chain.device
    dtype = operator_dtype(psi_z)
    if readout == "auto":
        readout = "apply" if dtype == torch.complex128 else "direct"
    if readout not in ("direct", "apply"):
        raise ValueError(
            f"coarse_to_fine_pole_search: unknown readout {readout!r}; use "
            "'direct', 'apply' or 'auto'"
        )
    psi_tight = tighten(psi_z) if readout == "direct" else psi_z

    if operators is None:
        def operators(wr):
            return tighten(zt_mpo(n, wr, engine=engine, cutoff=cutoff,
                                  maxdim=maxdim, dtype=dtype, cache=cache,
                                  cache_dir=cache_dir, device=device))

    def transform(wr):
        W = operators(wr)
        if readout == "direct":
            return W
        if apply_fused:
            return apply(W, psi_z, maxdim=maxdim, cutoff=cutoff)
        return apply(W, psi_z)

    def scan_one(state, ks, ls, wr):
        if readout == "direct":
            return _peak(chi_grid_direct(state, psi_tight, ks, ls), ks, ls,
                         n, wr, wi)
        return pole_scan(state, ks, ls, wr=wr, wi=wi)

    def arange(lo, hi, step=1):
        return torch.arange(lo, hi, step, dtype=torch.int64, device=device)

    # --- coarse ---
    stride_c = max(1, N // coarse_points)
    ks_c = arange(0, N, stride_c)
    coarse = scan_one(transform(wr_coarse), ks_c, ks_c, wr_coarse)

    # --- fine: re-center the coarse peak in the wr_fine coordinates ---
    state_f = transform(wr_fine)
    k_c, l_c = kl_from_z(coarse.z_peak, n, wr_fine, wi)
    k_c, l_c = k_c.to(device), l_c.to(device)
    half_k = max(1, int(round(stride_c * wr_coarse / wr_fine)))
    half_l = max(1, stride_c)
    stride_fk = max(1, (2 * half_k) // fine_points)
    stride_fl = max(1, (2 * half_l) // fine_points)
    ks_f = torch.clamp(k_c + arange(-half_k, half_k + 1, stride_fk), 0, N - 1)
    ls_f = torch.remainder(l_c + arange(-half_l, half_l + 1, stride_fl), N)
    fine = scan_one(state_f, ks_f, ls_f, wr_fine)

    # --- superfine: stride-1 zoom around the fine peak ---
    h = superfine_half
    ks_s = torch.clamp(fine.k_peak + arange(-h, h + 1), 0, N - 1)
    ls_s = torch.remainder(fine.l_peak + arange(-h, h + 1), N)
    superfine = scan_one(state_f, ks_s, ls_s, wr_fine)

    return PoleSearchResult(coarse=coarse, fine=fine, superfine=superfine)
