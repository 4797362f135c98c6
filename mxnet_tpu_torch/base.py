"""Base utilities: the framework error type and the dtype table.

Counterpart of ``mxnet_tpu/base.py`` (``MXNetError``, ``np_dtype``). The
dtype table maps NumPy dtypes and names onto ``torch.dtype`` and back, and
carries the reference's 32-bit canonicalization (JAX's default mode):

- a Python int gives int32, a Python float float32, a Python complex
  complex64;
- a host (NumPy) float64 array gives float32 and a complex128 one
  complex64, while a host int64 / uint64 array keeps its width (the
  reference keeps index arrays 64-bit, ``multiarray.py:983-993``);
- an explicit 64-bit ``dtype=`` is honoured.

``bfloat16`` has no NumPy dtype without ``ml_dtypes``; the port's
:data:`bfloat16` object stands for it and compares equal to the name
``"bfloat16"`` and to ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as onp
import torch


class MXNetError(RuntimeError):
    """Framework error type (reference: python/mxnet/base.py MXNetError)."""


class _BFloat16:
    """The dtype object of bfloat16 arrays (``ndarray.dtype``); equal to
    ``"bfloat16"``, ``torch.bfloat16`` and itself."""

    name = "bfloat16"
    itemsize = 2
    kind = "V"

    def __eq__(self, other):
        return other is self or other == "bfloat16" \
            or other is torch.bfloat16

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash("bfloat16")

    def __repr__(self):
        return "bfloat16"

    __str__ = __repr__

    def __reduce__(self):
        return "bfloat16"


bfloat16 = _BFloat16()

_TORCH_TO_NP = {
    torch.bool: onp.dtype("bool"), torch.uint8: onp.dtype("uint8"),
    torch.int8: onp.dtype("int8"), torch.int16: onp.dtype("int16"),
    torch.int32: onp.dtype("int32"), torch.int64: onp.dtype("int64"),
    torch.uint16: onp.dtype("uint16"), torch.uint32: onp.dtype("uint32"),
    torch.uint64: onp.dtype("uint64"), torch.float16: onp.dtype("float16"),
    torch.float32: onp.dtype("float32"), torch.float64: onp.dtype("float64"),
    torch.complex64: onp.dtype("complex64"),
    torch.complex128: onp.dtype("complex128"),
}
_NP_TO_TORCH = {v: k for k, v in _TORCH_TO_NP.items()}
#: host dtypes the 32-bit rule narrows when no dtype is asked for
_NARROW = {onp.dtype("float64"): torch.float32,
           onp.dtype("complex128"): torch.complex64}


def torch_dtype(dtype):
    """A ``torch.dtype`` from a dtype spec: a ``torch.dtype``, a NumPy dtype
    or type, a name ("bfloat16", "float32", ...), a Python type or the
    port's :data:`bfloat16`; ``None`` stays ``None``. An explicit 64-bit
    spec is honoured (``float`` names float64, as ``onp.dtype(float)``
    does)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if dtype is bfloat16 or (isinstance(dtype, str) and dtype == "bfloat16"):
        return torch.bfloat16
    try:
        dt = _NP_TO_TORCH.get(onp.dtype(dtype))
    except TypeError:
        dt = None
    if dt is None and isinstance(dtype, str):
        dt = getattr(torch, dtype, None)  # "float", "half", "long", ...
    if not isinstance(dt, torch.dtype):
        raise MXNetError(f"unknown dtype {dtype!r}")
    return dt


def np_dtype(dtype):
    """The NumPy dtype of a torch dtype (or any spec :func:`torch_dtype`
    takes); :data:`bfloat16` for bfloat16."""
    dt = torch_dtype(dtype)
    if dt is None:
        return None
    if dt is torch.bfloat16:
        return bfloat16
    return _TORCH_TO_NP[dt]


def host_dtype(arr):
    """The torch dtype the 32-bit rule gives a host (NumPy) array: float64
    -> float32, complex128 -> complex64, every other dtype kept."""
    dt = onp.dtype(arr.dtype)
    return _NARROW.get(dt) or _NP_TO_TORCH[dt]


def scalar_dtype(value):
    """The torch dtype of a Python scalar by the 32-bit rule."""
    if isinstance(value, (bool, onp.bool_)):
        return torch.bool
    if isinstance(value, int):
        return torch.int32
    if isinstance(value, float):
        return torch.float32
    if isinstance(value, complex):
        return torch.complex64
    raise MXNetError(f"not a scalar: {value!r}")
