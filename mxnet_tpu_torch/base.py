"""Base utilities: the framework error type and dtype names.

Counterpart of ``mxnet_tpu/base.py`` (``MXNetError``, ``np_dtype``),
trimmed to what the PyTorch/CUDA port uses.
"""
from __future__ import annotations

import torch


class MXNetError(RuntimeError):
    """Framework error type (reference: python/mxnet/base.py MXNetError)."""


def torch_dtype(dtype):
    """A ``torch.dtype`` from a dtype or its name ("bfloat16", "float32",
    ...), as the reference's ``np_dtype`` takes names."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = getattr(torch, str(dtype), None)
    if not isinstance(dt, torch.dtype):
        raise MXNetError(f"unknown dtype {dtype!r}")
    return dt
