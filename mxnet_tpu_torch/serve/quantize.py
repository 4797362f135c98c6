"""Weight-only low-bit storage for the decode path.

Counterpart of ``mxnet_tpu/serve/quantize.py``. Decode streams the whole
weight set from device memory for one token a slot, so int8 (a quarter of
the fp32 bytes) or int4 (about an eighth) storage cuts what a step reads,
with no activation quantization.

Schemes:

- **int8**: symmetric per-output-channel (zero-point 0) over eligible float
  parameters.
- **int4**: symmetric group-wise along the input axis
  (``serve.quantize_group_size`` columns a scale; rows whose width is not
  divisible take one scale a row), two nibbles a byte, the even column in
  the low nibble. Bytes per fp32 element: 1/8 for the nibbles + 4/group
  for the scales, ~0.133x at the default group of 128.

Eligibility follows ``serve.quantize_min_elems`` / ``serve.quantize_ndim``;
everything else (biases, LayerNorm vectors, small tensors) stays in float.
The serve engine dequantizes at the top of each step (unpack,
``to(dtype) * scale``) into the float weights its matmuls read: plain
PyTorch (the reference leaves the fusion to XLA; a fused dequantize-GEMV
kernel is speed work still to do). No calibration pass: the scales come
from the weights. Scales divide (no reciprocal multiply) and round half to
even, as the reference, so the stored values equal the JAX package's bit
for bit.
"""
from __future__ import annotations

import torch

from .. import config as _config

__all__ = ["eligible", "quantize_params_int8", "quantize_params_int4",
           "dequantize_params", "quantized_bytes"]

_INT8_MAX = 127.0
_INT4_MAX = 7.0

#: historical default for the eligibility floor; the live value is the
#: ``serve.quantize_min_elems`` config knob.
MIN_ELEMENTS = 4096


def _min_elements(v=None):
    return int(_config.get("serve.quantize_min_elems") if v is None else v)


def _ndim(v=None):
    return int(_config.get("serve.quantize_ndim") if v is None else v)


def _group_size(v=None):
    return int(_config.get("serve.quantize_group_size") if v is None else v)


def eligible(name, arr, min_elements=None, ndim=None):
    """Quantize only float matmul operands of meaningful size (rank and
    floor from the serve.quantize_* knobs unless overridden)."""
    arr = torch.as_tensor(arr)
    return (arr.ndim == _ndim(ndim) and arr.is_floating_point()
            and arr.numel() >= _min_elements(min_elements))


def _scales(absmax, top):
    # a true division (torch divides by a host scalar as a reciprocal
    # multiply on the card)
    scale = absmax / torch.full((), top, dtype=absmax.dtype,
                                device=absmax.device)
    return torch.where(scale == 0, torch.ones_like(scale), scale).float()


def quantize_params_int8(params, min_elements=None, ndim=None):
    """Split a name -> tensor dict into (passthrough, quantized, meta).

    quantized maps name -> (int8 weights, per-row float32 scales); meta
    maps the same names to the original dtype's name. Rows are output
    channels for every 2-D weight the framework stores: Dense keeps
    (units, in_units), Embedding (vocab, units), whose tied LM head reads
    it transposed, so row scales are per output channel there too."""
    passthrough, quantized, meta = {}, {}, {}
    for name, arr in params.items():
        if not eligible(name, arr, min_elements, ndim):
            passthrough[name] = arr
            continue
        a = torch.as_tensor(arr)
        # per row for the 2-D default; the last axis generalizes to any
        # rank serve.quantize_ndim admits (1-D: one scale)
        scale = _scales(a.abs().amax(dim=-1, keepdim=True), _INT8_MAX)
        q = torch.clamp(torch.round(a / scale), -_INT8_MAX, _INT8_MAX)
        quantized[name] = (q.to(torch.int8), scale)
        meta[name] = str(a.dtype).replace("torch.", "")
    return passthrough, quantized, meta


def quantize_params_int4(params, min_elements=None, ndim=None,
                         group_size=None):
    """int4 variant: group-wise symmetric scales along the input axis,
    nibbles packed two a byte (even column = low nibble).

    quantized maps name -> (packed uint8 (rows, cols//2), float32 scales
    (rows, cols//group)); meta entries are dicts ``{"mode": "int4",
    "dtype", "cols", "group"}``. Odd-width weights pass through (no half
    byte for the last nibble)."""
    g0 = _group_size(group_size)
    passthrough, quantized, meta = {}, {}, {}
    for name, arr in params.items():
        a = torch.as_tensor(arr)
        if not eligible(name, a, min_elements, ndim) or a.ndim != 2 \
                or a.shape[-1] % 2:
            passthrough[name] = arr
            continue
        rows, cols = a.shape
        g = g0 if g0 > 0 and cols % g0 == 0 else cols
        grouped = a.reshape(rows, cols // g, g)
        scale = _scales(grouped.abs().amax(dim=2), _INT4_MAX)
        q = torch.clamp(torch.round(grouped / scale[:, :, None]),
                        -_INT4_MAX, _INT4_MAX)
        q = q.to(torch.int8).reshape(rows, cols)
        lo = q[:, 0::2].to(torch.uint8) & 0xF
        hi = q[:, 1::2].to(torch.uint8) & 0xF
        quantized[name] = (lo | (hi << 4), scale)
        meta[name] = {"mode": "int4",
                      "dtype": str(a.dtype).replace("torch.", ""),
                      "cols": int(cols), "group": int(g)}
    return passthrough, quantized, meta


def _unpack_int4(packed, cols):
    """(rows, cols//2) uint8 -> (rows, cols) int8 in [-7, 7]."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], cols)


def dequantize_params(passthrough, quantized, meta):
    """Rebuild the full float parameter dict (the serve engine does it at
    the top of every step, inside its captured graphs)."""
    out = dict(passthrough)
    for name, (q, scale) in quantized.items():
        m = meta[name]
        if isinstance(m, dict):  # int4: unpack nibbles, group scales
            dtype = getattr(torch, m["dtype"])
            cols, g = m["cols"], m["group"]
            w = _unpack_int4(q, cols).to(dtype)
            w = (w.reshape(q.shape[0], cols // g, g)
                 * scale[:, :, None].to(dtype))
            out[name] = w.reshape(q.shape[0], cols)
        else:
            dtype = getattr(torch, m)
            out[name] = q.to(dtype) * scale.to(dtype)
    return out


def quantized_bytes(passthrough, quantized, meta):
    """(quantized footprint, original footprint) in bytes."""
    def nbytes(a):
        a = torch.as_tensor(a)
        return a.numel() * a.element_size()
    now = sum(nbytes(a) for a in passthrough.values())
    was = now
    for name, (q, scale) in quantized.items():
        m = meta[name]
        now += nbytes(q) + scale.numel() * 4
        if isinstance(m, dict):
            was += q.shape[0] * m["cols"] \
                * torch.empty((), dtype=getattr(torch, m["dtype"])) \
                .element_size()
        else:
            was += q.numel() * torch.empty((), dtype=getattr(torch, m)) \
                .element_size()
    return now, was
