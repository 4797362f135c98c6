"""fp8 fused dense: ``npx.fp8_dense_fused``.

Counterpart of the fp8 part of ``mxnet_tpu/ops/quantization.py``
(``FUSED_ACTS``, ``_route_fused``, ``fp8_dense_fused``); the plain chain
is ``quant_matmul.fp8_matmul_plain``, which applies the activation as the
reference's ``_apply_act`` does.
The int8 operators (``quantize_v2``, ``quantized_dense_fused``, ...) come
with the int8 slice of the port.

Routing by the ``quantize.fused_matmul`` knob: "auto" takes the CUDA
kernel (``ops/quant_matmul.py``) for a CUDA tensor, whose wrapper raises
on a card the kernel was not built for, and the plain chain for a CPU
tensor; "on" takes the kernel, and raises on the CPU (the reference's
interpret mode off the TPU has no CUDA counterpart); "off" takes the plain
chain.
"""
from __future__ import annotations

import torch

from .. import config as _config
from ..base import MXNetError
from .quant_matmul import FP8_FORMATS, fp8_matmul, fp8_matmul_plain

__all__ = ["FUSED_ACTS", "fp8_dense_fused"]

#: activations the fused epilogue computes (the kernel's set)
FUSED_ACTS = (None, "relu", "sigmoid", "tanh", "gelu")


def _route_fused(x):
    """Whether ``x`` goes through the kernel, per the knob."""
    mode = str(_config.get("quantize.fused_matmul")).lower()
    if mode not in ("auto", "on", "off"):
        raise MXNetError(f"quantize.fused_matmul must be 'auto', 'on' or "
                         f"'off', got {mode!r}")
    if mode == "off":
        return False
    if mode == "on":
        if x.device.type != "cuda":
            raise MXNetError(
                "quantize.fused_matmul='on' needs a CUDA tensor: the fp8 "
                "kernel has no interpret mode on the CPU")
        return True
    return x.device.type != "cpu"


def fp8_dense_fused(data, weight, x_scale, w_scale, bias=None, act=None,
                    flatten=True, fmt=None):
    """fp8-activation dense layer: quantize ``data / x_scale`` to ``fmt``,
    multiply with the pre-cast fp8 ``weight`` (units, in_units) in fp32,
    then ``acc * (x_scale * w_scale) + bias`` and ``act``.

    ``w_scale`` is per output channel, ``x_scale`` a scalar; the output is
    fp32 of shape ``lead + (units,)``."""
    if act not in FUSED_ACTS:
        raise ValueError(f"activation {act!r} cannot be fused; "
                         f"supported: {FUSED_ACTS}")
    fmt = fmt or _config.get("quantize.fp8_format")
    if fmt not in FP8_FORMATS:
        raise ValueError(f"unknown fp8 format {fmt!r}")
    h = data.reshape(data.shape[0], -1) if flatten else data
    lead = tuple(h.shape[:-1])
    h2 = h.reshape(-1, h.shape[-1]).float()
    w_scale = torch.as_tensor(w_scale, dtype=torch.float32,
                              device=data.device)
    if _route_fused(data):
        out = fp8_matmul(h2.contiguous(), weight.contiguous(),
                         w_scale.contiguous(), x_scale,
                         bias=None if bias is None else
                         bias.float().contiguous(), act=act, fmt=fmt)
    else:
        out = fp8_matmul_plain(h2, weight, w_scale, x_scale, bias, act, fmt)
    return out.reshape(lead + (weight.shape[0],))
