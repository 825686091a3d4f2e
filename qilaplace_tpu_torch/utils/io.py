"""Serialization of tensor-train containers and the operator artifact cache.

Counterpart of ``qilaplace_tpu/utils/io.py`` (``save``, ``load``,
``default_cache_dir``, ``cached_mpo``, ``cached_zt_mpo``,
``cached_zt_pack``). The ``.npz`` format is the JAX package's: complex
arrays are stored as split ``.re``/``.im`` halves, and the cache keys name
files alike, so artifacts written by either package load in both.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from qilaplace_tpu_torch.core.mpo import MPO, PairedSiteMPO
from qilaplace_tpu_torch.core.mps import MPS, ZTMPS
from qilaplace_tpu_torch.utils.config import dtype_name, resolve_device


def _split(prefix: str, arr: torch.Tensor, out: dict) -> None:
    a = arr.detach().cpu().numpy()
    if np.iscomplexobj(a):
        out[prefix + ".re"] = np.ascontiguousarray(a.real)
        out[prefix + ".im"] = np.ascontiguousarray(a.imag)
    else:
        out[prefix] = a


def _join(prefix: str, data: dict, device) -> torch.Tensor:
    if prefix + ".re" in data:
        a = data[prefix + ".re"] + 1j * data[prefix + ".im"]
        # keep the stored width: f32 halves make complex64
        a = a.astype(np.result_type(data[prefix + ".re"], np.complex64))
    else:
        a = data[prefix]
    return torch.from_numpy(np.asarray(a)).to(device)


def save(path: str, obj, *, compress: bool = True) -> None:
    """Save an MPS / ZTMPS / MPO / PairedSiteMPO to ``path`` (.npz)."""
    chain = obj.chain if isinstance(obj, (ZTMPS, PairedSiteMPO)) else obj
    out: dict = {"kind": np.asarray(type(obj).__name__)}
    _split("cores", chain.cores, out)
    out["ranks"] = chain.ranks.cpu().numpy()
    if isinstance(chain, MPS):
        _split("amplitude", chain.amplitude, out)
    (np.savez_compressed if compress else np.savez)(path, **out)


def load(path: str, *, device=None):
    """Load a container saved by :func:`save` (by either package) onto
    ``device`` (the card unless told otherwise)."""
    device = resolve_device(device)
    data = dict(np.load(path, allow_pickle=False))
    kind = str(data["kind"])
    cores = _join("cores", data, device)
    ranks = torch.from_numpy(data["ranks"].astype(np.int32)).to(device)
    if kind in ("MPS", "ZTMPS"):
        chain = MPS(cores=cores, ranks=ranks,
                    amplitude=_join("amplitude", data, device))
        return ZTMPS(chain=chain) if kind == "ZTMPS" else chain
    chain = MPO(cores=cores, ranks=ranks)
    return PairedSiteMPO(chain=chain) if kind == "PairedSiteMPO" else chain


def default_cache_dir() -> str:
    """Operator artifact cache directory (env ``QILAPLACE_MPO_CACHE``
    overrides)."""
    return os.environ.get(
        "QILAPLACE_MPO_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "qilaplace_mpo"),
    )


def _atomic_write(path: str, write) -> None:
    """``write(tmp)`` then rename, so concurrent builders never observe a
    torn file."""
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=os.path.dirname(path))
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def cached_mpo(name: str, build_fn, *, cache_dir: str | None = None,
               device=None):
    """Load ``<cache_dir>/<name>.npz`` onto ``device`` if present, else run
    ``build_fn()``, persist and return. Returns ``(W, cache_hit)``."""
    device = resolve_device(device)
    if cache_dir is None:
        cache_dir = default_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, name + ".npz")
    if os.path.exists(path):
        return load(path, device=device), True
    W = build_fn()
    _atomic_write(path, lambda tmp: save(tmp, W, compress=False))
    return W, False


def cached_zt_mpo(
    n: int,
    wr: float,
    *,
    cutoff: float,
    maxdim: int,
    chi: int | None = None,
    dtype=torch.complex64,
    chi_work: int | None = None,
    cache_dir: str | None = None,
    device=None,
    engine: str = "gate",
):
    """zT MPO behind the persistent artifact cache, keyed on (engine, n, wr,
    cutoff, maxdim, chi, dtype, chi_work) exactly as the JAX package keys
    it. ``engine``: "gate" (the gate-layer fold, transforms/zt.py) or
    "analytic" (the rail-cross builder, transforms/analytic.py). Returns
    ``(W, cache_hit)``."""
    device = resolve_device(device)
    name = (
        f"zt_{engine}_n{n}_wr{float(wr):.12g}_c{float(cutoff):.6g}"
        f"_m{int(maxdim)}_chi{0 if chi is None else int(chi)}"
        f"_{dtype_name(dtype)}"
        f"_w{0 if chi_work is None else int(chi_work)}"
    )

    def build():
        if engine == "analytic":
            from qilaplace_tpu_torch.transforms.analytic import analytic_zt_mpo

            return analytic_zt_mpo(n, wr, cutoff=cutoff, maxdim=maxdim,
                                   chi=chi, dtype=dtype, device=device)
        if engine == "gate":
            from qilaplace_tpu_torch.transforms.zt import build_zt_mpo

            return build_zt_mpo(n, wr, cutoff=cutoff, maxdim=maxdim, chi=chi,
                                dtype=dtype, chi_work=chi_work, device=device)
        raise ValueError(
            f"cached_zt_mpo: unknown engine {engine!r}; "
            "use 'analytic' or 'gate'"
        )

    return cached_mpo(name, build, cache_dir=cache_dir, device=device)


def cached_zt_pack(
    n: int,
    wr: float,
    *,
    cutoff: float,
    maxdim: int,
    chi: int | None = None,
    seed: int = 7,
    cache_dir: str | None = None,
):
    """zT factor pack (host numpy dict) behind the same artifact cache.
    Returns ``(pack, cache_hit)``."""
    from qilaplace_tpu_torch.transforms.analytic import zt_product_pack

    if cache_dir is None:
        cache_dir = default_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    name = (
        f"ztpack_n{n}_wr{float(wr):.12g}_c{float(cutoff):.6g}"
        f"_m{int(maxdim)}_chi{0 if chi is None else int(chi)}_s{int(seed)}"
    )
    path = os.path.join(cache_dir, name + ".npz")
    if os.path.exists(path):
        return dict(np.load(path, allow_pickle=False)), True
    pack = zt_product_pack(n, wr, cutoff=cutoff, maxdim=maxdim, chi=chi,
                           seed=seed)
    _atomic_write(path, lambda tmp: np.savez(tmp, **pack))
    return pack, False
