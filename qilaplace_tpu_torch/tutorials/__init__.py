"""The reference's four tutorials, run through the port.

Counterparts of ``docs/tutorials/{signal,dft,dt,zt}.py``, in that order:
each later one uses more of the API. Each module follows its JAX
counterpart section by section, prints what it prints and exposes
``run(device=None, dtype=torch.complex64) -> dict``, which returns those
numbers under stable keys and asserts the tutorial's own facts, with the
bars stated per dtype in the module. The inputs are made in float64 numpy
(``inputs()``) and cast to the run's dtype before the encode, so the JAX
package can be fed the same arrays. No figure is drawn and no file is
written: each module prints the peaks the JAX figures plot.

Run one from the repository root::

    python -m qilaplace_tpu_torch.tutorials.zt                    # the card
    python -m qilaplace_tpu_torch.tutorials.zt --device cpu --dtype complex128

The card runs complex64: kernel K1 takes complex64 chains and kernel K2
float32 / complex64 matrices only, so a complex128 run on the card would
launch neither and send every factorization to the plain Jacobi solver.
"""

from __future__ import annotations

import argparse

import torch

from qilaplace_tpu_torch.utils.config import real_dtype, resolve_device

DTYPES = {"complex64": torch.complex64, "complex128": torch.complex128}


def setup(device, dtype):
    """(device, real dtype) of a run in ``dtype``; raises for a dtype other
    than complex64 / complex128."""
    if dtype not in DTYPES.values():
        raise ValueError(f"tutorials run in complex64 or complex128, not "
                         f"{dtype}")
    return resolve_device(device), real_dtype(dtype)


def check(cond: bool, what: str) -> None:
    """One of a tutorial's facts; raises (under ``python -O`` too)."""
    if not cond:
        raise AssertionError(what)


def main(run) -> None:
    """Command line of one tutorial: ``--device``, ``--dtype``."""
    parser = argparse.ArgumentParser(description=run.__module__)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--dtype", default="complex64", choices=DTYPES)
    args = parser.parse_args()
    run(device=args.device, dtype=DTYPES[args.dtype])
