"""Device resolution.

Counterpart of ``mxnet_tpu/context.py``. The port runs on the card: with
no device given it resolves to ``cuda:0`` and raises when CUDA is absent,
never carrying on silently on the host. The CPU is used only when a caller
asks for it by name (``device="cpu"``), as the CPU tests do.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``None`` -> ``cuda:0`` (raises without CUDA); anything else -> the
    ``torch.device`` it names (a CUDA device that is absent raises)."""
    if device is None:
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device available; pass device='cpu' to run on the "
                "host explicitly")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(f"device {device!r} requested but CUDA is not "
                             "available")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev

