"""Base utilities: the framework error type.

Counterpart of ``mxnet_tpu/base.py`` (``MXNetError``), trimmed to what the
PyTorch/CUDA port's serving slice raises.
"""
from __future__ import annotations


class MXNetError(RuntimeError):
    """Framework error type (reference: python/mxnet/base.py MXNetError)."""
