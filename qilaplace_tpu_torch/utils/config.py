"""Global defaults: chi buckets, dtype helpers and the matmul precision switch.

Counterpart of ``qilaplace_tpu/utils/config.py``. The JAX package wraps
every public entry point in ``highest_precision`` because TPU matmuls
default to bf16 inputs; here one process-wide switch does the same job:
:func:`set_highest_precision` turns TF32 off for matmuls and cuDNN, so a
float32 contraction on the card accumulates in full float32.
"""

from __future__ import annotations

import numpy as np
import torch

# Padded bond-dimension buckets (same values as the JAX package, so both
# packages pad a given rank to the same width).
CHI_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def bucket_for(chi: int) -> int:
    """Smallest bucket >= chi."""
    for b in CHI_BUCKETS:
        if b >= chi:
            return b
    return int(chi)


def default_device() -> torch.device:
    """Where the port's entry points run unless told otherwise: the card.
    There is no fallback: without a CUDA device, callers that take the
    default fail, and host runs (the tests, host-only helpers) pass
    ``device="cpu"``."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device``, or :func:`default_device` for None; raises when the
    default is asked for and there is no CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the host"
        )
    return default_device()


def set_highest_precision() -> None:
    """Full-float32 matmuls everywhere (no TF32 in matmul or cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real dtype of the same width (complex64 -> float32, ...)."""
    return torch.empty((), dtype=dtype).real.dtype


def dtype_name(dtype) -> str:
    """numpy-style name of a torch or numpy dtype ("complex64", ...); the
    artifact cache keys use it so both packages name files alike."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def to_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)
