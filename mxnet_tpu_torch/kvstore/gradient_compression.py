"""1-bit and 2-bit gradient compression with the error-feedback residual.

Counterpart of ``mxnet_tpu/kvstore/gradient_compression.py`` (reference:
src/kvstore/gradient_compression.h): a key's gradient plus its residual is
quantized to {-t, 0, +t} ("2bit": +t at or above t, -t at or below -t) or
{-t, +t} ("1bit": the sign around 0), and the residual keeps what the
quantization left out. The quantized values are exact multiples of the
threshold, so summing them is exact. ``pack_codes`` / ``unpack_codes``
give the wire format (2-bit codes 0 -> 00, +t -> 01, -t -> 10, four to a
byte; 1-bit +t -> 1, -t -> 0, eight to a byte; lowest bits first), bit for
bit with the reference's.
"""
from __future__ import annotations

import numpy as onp
import torch

from ..base import MXNetError

__all__ = ["GradientCompression", "pack_codes", "unpack_codes"]


def _quantize(x, residual, threshold, mode):
    """(q, new residual) of ``x + residual``."""
    acc = x + residual
    t = torch.full((), threshold, dtype=x.dtype, device=x.device)
    if mode == "2bit":
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        q = torch.where(acc >= t, t, torch.where(acc <= -t, -t, zero))
    else:
        q = torch.where(acc >= 0, t, -t)
    return q, acc - q


class GradientCompression:
    """Per-key quantizer with its residual (reference:
    gradient_compression.py ``GradientCompression``)."""

    def __init__(self, type="2bit", threshold=0.5):  # noqa: A002
        if type not in ("1bit", "2bit"):
            raise MXNetError(f"unsupported compression type {type!r} "
                             "(reference supports '1bit'/'2bit')")
        if float(threshold) <= 0:
            raise MXNetError("compression threshold must be positive")
        self.type = type
        self.threshold = float(threshold)
        self._residual = {}

    def quantize(self, key, grad):
        """The quantized gradient of ``key`` (a tensor); its residual is
        kept for the key's next call."""
        res = self._residual.get(key)
        if res is None or res.shape != grad.shape:
            res = torch.zeros_like(grad)
        q, self._residual[key] = _quantize(grad, res, self.threshold,
                                           self.type)
        return q

    def get_params(self):
        return {"type": self.type, "threshold": self.threshold}


def _host(q):
    if isinstance(q, torch.Tensor):
        return q.detach().float().cpu().numpy()
    return onp.asarray(getattr(q, "_data", q), dtype="float32")


def pack_codes(q, threshold, mode="2bit"):
    """Quantized values -> (packed uint8 numpy array, element count)."""
    flat = _host(q).astype("float32").reshape(-1)
    if mode == "2bit":
        codes = onp.where(flat > 0, 1, onp.where(flat < 0, 2, 0)) \
            .astype("uint8")
        per, width = 4, 2
    else:
        codes = (flat >= 0).astype("uint8")
        per, width = 8, 1
    codes = onp.pad(codes, (0, (-len(codes)) % per))
    packed = onp.zeros(len(codes) // per, dtype="uint8")
    for i in range(per):
        packed |= codes[i::per] << (width * i)
    return packed, len(flat)


def unpack_codes(packed, n, threshold, mode="2bit", dtype="float32"):
    """Packed bytes -> the quantized values (numpy; inverse of
    :func:`pack_codes`)."""
    packed = onp.asarray(packed, dtype="uint8")
    if mode == "2bit":
        per, width, mask = 4, 2, 0b11
        lut = onp.array([0.0, threshold, -threshold, 0.0], dtype=dtype)
    else:
        per, width, mask = 8, 1, 0b1
        lut = onp.array([-threshold, threshold], dtype=dtype)
    codes = onp.zeros(len(packed) * per, dtype="uint8")
    for i in range(per):
        codes[i::per] = (packed >> (width * i)) & mask
    return lut[codes[:n]]
