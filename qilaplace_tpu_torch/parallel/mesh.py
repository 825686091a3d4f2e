"""Batched pipelines and their sharding over a mesh of devices.

Counterpart of ``qilaplace_tpu/parallel/mesh.py``. The workload's parallel
axes are the embarrassingly parallel ones:

* ``dp`` (data/batch): many signals encoded and transformed at once. The
  JAX package gets the batch from ``jax.vmap``, which adds it to the grid
  of every kernel it reaches; here every tensor carries the batch axis
  first (core/mps.py) and each factorization of a batch is one eigensolve
  call, so on the card one K2 launch serves the whole batch;
* ``grid``: the (k, l) readout points of one state, and in the
  multi-operator scan a stack of operators on ``dp``.

As in the JAX program, one process drives every device: a :class:`Mesh`
holds ``torch.device`` objects shaped by its axes, :func:`shard_batch` and
:func:`replicate` place chunks and copies, and each sharded function runs
every shard on its device and gathers the result on the mesh's first
device. ``fit_mpo_step`` sums the shards' loss and gradient there (the
JAX program's psum). Nothing here needs ``torch.distributed``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qilaplace_tpu_torch.core.mpo import MPO, PairedSiteMPO, _mpo_chain, mpo_repad
from qilaplace_tpu_torch.core.mps import coefficient_batch
from qilaplace_tpu_torch.ops.apply import apply, apply_coefficient_batch
from qilaplace_tpu_torch.signals.encode import signal_mps
from qilaplace_tpu_torch.utils.config import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out on named axes: ``devices`` is a numpy object array
    of ``torch.device`` whose axes are ``axis_names``."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def flat(self) -> list:
        """Every device, the axes flattened in order."""
        return list(self.devices.reshape(-1))

    @property
    def first(self) -> torch.device:
        """Where the sharded functions gather their results."""
        return self.devices.reshape(-1)[0]

    def along(self, axis: str) -> list:
        """The devices along ``axis``, at index 0 of every other axis."""
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[k] = slice(None)
        return list(self.devices[tuple(index)])


@dataclasses.dataclass
class Sharded:
    """A batch split along its leading axis: ``chunks[i]`` (a tensor or a
    batched container) lies on ``devices[i]``."""

    chunks: list
    devices: list


@dataclasses.dataclass
class Replicated:
    """One copy of a tensor or container on each device of a mesh."""

    copies: list
    devices: list

    def on(self, device) -> object:
        return self.copies[self.devices.index(torch.device(device))]


def _map(fn, obj):
    """``fn`` applied to every tensor of a tensor or a (nested) container."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    raise TypeError(f"not a tensor or a container: {type(obj).__name__}")


def _leaves(obj) -> list:
    out = []
    _map(out.append, obj)
    return out


def _local(obj, device):
    """``obj`` on ``device``: a replica's copy there, else moved there."""
    if isinstance(obj, Replicated):
        return obj.on(device)
    return _map(lambda t: t.to(device), obj)


def _cat(parts, device):
    """Concatenate batched tensors or containers along the leading axis, on
    ``device``."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    return dataclasses.replace(first, **{
        f.name: _cat([getattr(p, f.name) for p in parts], device)
        for f in dataclasses.fields(first)})


def _split(obj, k: int, what: str) -> list:
    """``obj``'s leading axis in ``k`` equal parts (a shard-shape
    requirement, as for a ``NamedSharding``)."""
    size = _leaves(obj)[0].shape[0]
    if size % k:
        raise ValueError(
            f"{what}: leading axis {size} does not divide into {k} shards")
    return [_map(lambda t, i=i: t.tensor_split(k)[i], obj) for i in range(k)]


def make_mesh(n_devices: int | None = None, axis_names=("dp", "grid"),
              shape=None, *, devices=None) -> Mesh:
    """A mesh of ``n_devices`` devices (default: all). ``devices`` defaults
    to every CUDA device and raises without one; pass e.g.
    ``["cpu"] * 8`` for a host mesh. The default shape puts every device on
    the first axis; pass ``shape`` to split, e.g. (4, 2)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices=['cpu'] * n for a "
                "mesh on the host")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(
            f"make_mesh: {n_devices} devices asked, {len(devices)} given")
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices[:n_devices]
    return Mesh(grid.reshape(shape), tuple(axis_names))


def shard_batch(mesh: Mesh, x, axis: str = "dp") -> Sharded:
    """Split a batched tensor or container along its leading axis over the
    devices of ``axis``."""
    devs = mesh.along(axis)
    return Sharded(
        chunks=[_local(c, d) for c, d in
                zip(_split(x, len(devs), "shard_batch"), devs)],
        devices=devs)


def replicate(mesh: Mesh, tree) -> Replicated:
    """A copy of a tensor or container (e.g. an MPO) on every device."""
    devs = list(dict.fromkeys(mesh.flat))
    return Replicated(copies=[_local(tree, d) for d in devs], devices=devs)


def batched_signal_mps(xs, *, chi: int, cutoff: float = 1e-12,
                       method: str = "svd", device=None, **kw):
    """Encode a batch of signals [B, N] into one batched MPS (every field
    with B first). A :class:`Sharded` batch is encoded shard by shard on
    its devices and gathered on the first; otherwise on ``device`` (the
    card unless told otherwise). ``method`` is 'svd' or 'rsvd'."""
    if method == "cross":
        # the host cross encoder samples one signal at a time; jax.vmap
        # cannot trace it either
        raise ValueError("batched_signal_mps: method='cross' has no batch "
                         "form; use 'svd' or 'rsvd'")

    def encode(x, dev):
        return signal_mps(x, cutoff=cutoff, chi=chi, method=method,
                          device=dev, **kw)

    if isinstance(xs, Sharded):
        return _cat([encode(x, d) for x, d in zip(xs.chunks, xs.devices)],
                    xs.devices[0])
    return encode(xs, resolve_device(device))


def batched_qft_pipeline(W, xs, configs, *, chi: int,
                         cutoff: float = 1e-12, device=None) -> torch.Tensor:
    """Encode a batch of signals, apply ``W`` (the zip-up), read out
    ``configs``: xs [B, N], configs [C, n] -> [B, C] coefficients. A
    :class:`Sharded` batch runs shard by shard on its devices (``W`` may be
    :class:`Replicated`) and is gathered on the first device; otherwise it
    runs on ``device`` (the card unless told otherwise)."""

    def one(x, dev):
        psi = signal_mps(x, cutoff=cutoff, chi=chi, device=dev)
        out = apply(_local(W, dev), psi, maxdim=chi, cutoff=cutoff)
        return coefficient_batch(out, _local(configs, dev))

    if isinstance(xs, Sharded):
        return _cat([one(x, d) for x, d in zip(xs.chunks, xs.devices)],
                    xs.devices[0])
    return one(xs, resolve_device(device))


def sharded_chi_grid(mesh: Mesh, psi, configs) -> torch.Tensor:
    """Readout of one state with the config batch [B, 2n] split over every
    device of the mesh (B must divide by the mesh size); returns [B] on the
    mesh's first device."""
    devs = mesh.flat
    parts = _split(torch.as_tensor(configs), len(devs), "sharded_chi_grid")
    return _cat([coefficient_batch(_local(psi, d), c.to(d))
                 for c, d in zip(parts, devs)], mesh.first)


def stack_mpos(Ws, chi: int | None = None):
    """Stack same-length MPOs into one operator-batched container
    (repadded to a common bucket first): every field carries the operator
    axis first."""
    chains = [_mpo_chain(W) for W in Ws]
    if chi is None:
        chi = max(c.chi for c in chains)
    chains = [c if c.chi == chi else mpo_repad(c, chi) for c in chains]
    batched = MPO(cores=torch.stack([c.cores for c in chains]),
                  ranks=torch.stack([c.ranks for c in chains]))
    if isinstance(Ws[0], PairedSiteMPO):
        return PairedSiteMPO(chain=batched)
    return batched


def multi_mpo_chi_batch(Ws_stacked, psi, configs) -> torch.Tensor:
    """Direct ``<config| W_i |psi>`` for a stack of operators
    (:func:`stack_mpos`): [n_ops, B], one contraction chain for all."""
    return apply_coefficient_batch(Ws_stacked, psi, configs)


def sharded_multi_scan(mesh: Mesh, Ws_stacked, psi, configs) -> torch.Tensor:
    """:func:`multi_mpo_chi_batch` over the mesh: the operator stack split
    on ``dp``, the configs on ``grid``, psi on every device. n_ops must
    divide by the dp size and the config count by the grid size. Returns
    [n_ops, B] on the mesh's first device."""
    names = mesh.axis_names
    if sorted(names) != ["dp", "grid"]:
        raise ValueError("sharded_multi_scan: the mesh's axes must be dp "
                         "and grid")
    devices = np.transpose(mesh.devices,
                           [names.index("dp"), names.index("grid")])
    dp, grid = devices.shape
    paired = isinstance(Ws_stacked, PairedSiteMPO)
    ops = _split(_mpo_chain(Ws_stacked), dp, "sharded_multi_scan operators")
    cfgs = _split(torch.as_tensor(configs), grid,
                  "sharded_multi_scan configs")
    rows = []
    for i, W in enumerate(ops):
        row = []
        for j, c in enumerate(cfgs):
            d = devices[i, j]
            Wd = _local(W, d)
            Wd = PairedSiteMPO(chain=Wd) if paired else Wd
            row.append(apply_coefficient_batch(Wd, _local(psi, d),
                                               c.to(d)).to(mesh.first))
        rows.append(torch.cat(row, dim=1))
    return torch.cat(rows)


def fit_mpo_step(W: MPO, psis, configs, targets, lr: float = 0.1):
    """One SGD step fitting an MPO so that applying it to a batch of states
    reproduces target coefficients.

    psis: a batched MPS or its :class:`Sharded` form; configs [C, n];
    targets [B, C] (or :class:`Sharded` alike). The loss is the mean over
    the batch of sum |coefficient_batch(apply(W, psi), configs) - target|^2
    through the exact apply and the plain readout; each shard's loss sum
    and gradient (torch.autograd) are summed on W's device and divided by
    the whole batch. Returns (W', loss).

    For a real loss of complex cores torch's gradient is the conjugate of
    ``jax.grad``'s, so the JAX package's ``W - lr * conj(grad)`` is
    ``W - lr * grad`` here.
    """
    home = W.devices[0] if isinstance(W, Replicated) else W.device
    W0 = _local(W, home)
    if isinstance(psis, Sharded):
        tgts = (targets.chunks if isinstance(targets, Sharded)
                else _split(targets, len(psis.chunks), "fit_mpo_step"))
        shards = list(zip(psis.chunks, tgts, psis.devices))
    else:
        shards = [(psis, targets, home)]
    loss = torch.zeros((), dtype=W0.cores.real.dtype, device=home)
    grad = torch.zeros_like(W0.cores)
    batch = 0
    for psi, tgt, dev in shards:
        Wd = _local(W, dev)
        cores = Wd.cores.detach().requires_grad_(True)
        got = coefficient_batch(apply(MPO(cores=cores, ranks=Wd.ranks), psi),
                                _local(configs, dev))
        diff = got - tgt.to(dev)
        part = (diff.conj() * diff).real.sum()
        (g,) = torch.autograd.grad(part, cores)
        loss += part.detach().to(home)
        grad += g.to(home)
        batch += tgt.shape[0]
    new_cores = W0.cores.detach() - lr * (grad / batch)
    return MPO(cores=new_cores, ranks=W0.ranks), loss / batch
