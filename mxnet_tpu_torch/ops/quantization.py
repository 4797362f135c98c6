"""int8 and fp8 quantization operators: ``npx.quantize_v2``, ``dequantize``,
``quantized_fully_connected``, ``quantized_conv``, ``quantized_dense_fused``,
``quantized_conv_fused`` and ``fp8_dense_fused``.

Counterpart of ``mxnet_tpu/ops/quantization.py`` (``_scale_from_range``,
``quantize_v2``, ``dequantize``, ``quantized_fully_connected``,
``FUSED_ACTS``, ``_route_fused``, ``quantized_conv``,
``quantized_dense_fused``, ``quantized_conv_fused``, ``fp8_dense_fused``). The scheme is the reference's: symmetric int8
(zero-point 0), a per-tensor activation scale, per-output-channel weight
scales. The int8 products are summed exactly (as float64, which equals the
reference's int32 accumulation for every integer below 2^53: torch has no
integer matmul on CUDA) and rounded to fp32 once. The plain fused chains
are ``quant_matmul.quantized_matmul_plain`` and ``fp8_matmul_plain``, which
apply the activation as the reference's ``_apply_act`` does.
``quantized_conv`` and ``quantized_conv_fused`` sum their int8 products the
same way, through a float64 convolution of the int8 values (a 3x3 conv
over 512 channels sums 4608 products of up to 127^2, about 7.4e7, exact in
float64): the reference has no Pallas conv kernel (XLA's int8 conv runs
there), so neither has the port.

Routing of the fused dense layers by the ``quantize.fused_matmul`` knob:
"auto" takes the CUDA kernel (``ops/quant_matmul.py``) for a CUDA tensor,
whose wrapper raises on a card the kernel was not built for, and the plain
chain for a CPU tensor; "on" takes the kernel, and raises on the CPU (the
reference's interpret mode off the TPU has no CUDA counterpart); "off"
takes the plain chain.
"""
from __future__ import annotations

import torch

from .. import config as _config
from ..base import MXNetError
from ..numpy_extension import _ACTS, _CONV, _channel_first
from .quant_matmul import (_INT8_MAX, FP8_FORMATS, _scale_tensor,
                           fp8_matmul, fp8_matmul_plain, quantize_int8,
                           quantized_matmul, quantized_matmul_plain)

__all__ = ["FUSED_ACTS", "quantize_v2", "dequantize",
           "quantized_fully_connected", "quantized_conv",
           "quantized_dense_fused", "quantized_conv_fused",
           "fp8_dense_fused"]

#: activations the fused epilogue computes (the kernels' set)
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
                "quantize.fused_matmul='on' needs a CUDA tensor: the CUDA "
                "kernels have no interpret mode on the CPU")
        return True
    return x.device.type != "cpu"


def _as_range(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _scale_from_range(min_range, max_range):
    """``max(|min|, |max|) / 127``, a true fp32 division."""
    mx = torch.maximum(min_range.abs(), max_range.abs())
    return mx / mx.new_tensor(_INT8_MAX)


def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """float32 -> (int8, min_range, max_range) (reference:
    quantize_v2-inl.h): the calibrated range where both ends are given,
    else the runtime ``max |data|``. Symmetric: zero maps to zero."""
    if out_type != "int8":
        raise NotImplementedError("the port quantizes to int8 only")
    if min_calib_range is None or max_calib_range is None:
        mx = data.float().abs().max()
        mn = -mx
    else:
        mn = _as_range(min_calib_range, data.device)
        mx = _as_range(max_calib_range, data.device)
    return quantize_int8(data, _scale_from_range(mn, mx)), mn, mx


def dequantize(data, min_range, max_range, out_type="float32"):
    """int8 -> float32 (reference: dequantize-inl.h)."""
    scale = _scale_from_range(_as_range(min_range, data.device),
                              _as_range(max_range, data.device))
    return data.float() * scale


def _flatten(data, flatten):
    return data.reshape(data.shape[0], -1) if flatten else data


def quantized_fully_connected(data, weight, x_scale, w_scale, bias=None,
                              flatten=True):
    """int8 x int8 -> fp32 dense layer (reference:
    quantized_fully_connected.cc, in the JAX package's signature): ``data``
    and ``weight`` (units, in_units) int8, ``x_scale`` a scalar,
    ``w_scale`` per output channel; ``acc * (x_scale * w_scale) + bias``."""
    h = _flatten(data, flatten)
    acc = (h.double() @ weight.double().t()).float()
    out = acc * (_scale_tensor(x_scale, data.device)
                 * _as_range(w_scale, data.device))
    if bias is not None:
        out = out + bias
    return out


def quantized_conv(data, weight, x_scale, w_scale, bias=None, kernel=None,
                   stride=None, dilate=None, pad=None, num_filter=1,
                   num_group=1, layout="NCHW"):
    """int8 x int8 -> fp32 convolution (reference: quantized_conv.cc, in
    the JAX package's signature): ``data`` and ``weight`` (O, I/groups,
    *kernel) int8, ``x_scale`` a scalar, ``w_scale`` per output channel.
    The products are summed exactly (a float64 convolution of the int8
    values) and rounded to fp32 once; then ``acc * (x_scale * w_scale) +
    bias``."""
    nd = data.ndim - 2
    _channel_first(layout, nd)
    acc = _CONV[nd](data.double(), weight.double(),
                    stride=tuple(stride or (1,) * nd),
                    padding=tuple(pad or (0,) * nd),
                    dilation=tuple(dilate or (1,) * nd),
                    groups=num_group).float()
    shape = (1, -1) + (1,) * nd
    out = acc * (_scale_tensor(x_scale, data.device)
                 * _as_range(w_scale, data.device).reshape(shape))
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def quantized_conv_fused(data, weight, x_scale, w_scale, bias=None,
                         act=None, kernel=None, stride=None, dilate=None,
                         pad=None, num_filter=1, num_group=1, layout="NCHW"):
    """Fused quantize -> int8 conv -> dequant + bias + act: ``data`` (fp32)
    quantized by ``quantize_int8(data, x_scale)``, then
    :func:`quantized_conv`'s product and epilogue and the activation, in
    the reference's order."""
    _check_act(act)
    out = quantized_conv(quantize_int8(data, x_scale), weight, x_scale,
                         w_scale, bias, kernel, stride, dilate, pad,
                         num_filter, num_group, layout)
    return out if act is None else _ACTS[act](out)


def _fused_args(data, flatten, w_scale):
    """(h2, lead, w_scale): ``data`` flattened as the reference does, as a
    contiguous fp32 (rows, in_units) matrix (the pooler's ``seq[:, 0, :]``
    is a strided view), and ``w_scale`` as fp32 on its device."""
    h = _flatten(data, flatten)
    h2 = h.reshape(-1, h.shape[-1]).float().contiguous()
    return h2, tuple(h.shape[:-1]), _as_range(w_scale, data.device)


def _check_act(act):
    if act not in FUSED_ACTS:
        raise ValueError(f"activation {act!r} cannot be fused; "
                         f"supported: {FUSED_ACTS}")


def quantized_dense_fused(data, weight, x_scale, w_scale, bias=None,
                          act=None, flatten=True):
    """Fused quantize -> int8 x int8 product -> dequant + bias + act dense
    layer: ``weight`` is pre-quantized int8 (units, in_units), ``w_scale``
    per output channel, ``x_scale`` the calibrated threshold / 127; the
    output is fp32 of shape ``lead + (units,)``. The kernel route is
    ``quant_matmul.quantized_matmul`` (kernel 6)."""
    _check_act(act)
    h2, lead, w_scale = _fused_args(data, flatten, w_scale)
    b = None if bias is None else bias.float().contiguous()
    if _route_fused(data):
        out = quantized_matmul(h2, weight.contiguous(),
                               w_scale.contiguous(), x_scale, bias=b, act=act)
    else:
        out = quantized_matmul_plain(h2, weight, w_scale, x_scale, b, act)
    return out.reshape(lead + (weight.shape[0],))


def fp8_dense_fused(data, weight, x_scale, w_scale, bias=None, act=None,
                    flatten=True, fmt=None):
    """fp8-activation dense layer: quantize ``data / x_scale`` to ``fmt``,
    multiply with the pre-cast fp8 ``weight`` (units, in_units) in fp32,
    then ``acc * (x_scale * w_scale) + bias`` and ``act``.

    ``w_scale`` is per output channel, ``x_scale`` a scalar; the output is
    fp32 of shape ``lead + (units,)``."""
    _check_act(act)
    fmt = fmt or _config.get("quantize.fp8_format")
    if fmt not in FP8_FORMATS:
        raise ValueError(f"unknown fp8 format {fmt!r}")
    h2, lead, w_scale = _fused_args(data, flatten, w_scale)
    b = None if bias is None else bias.float().contiguous()
    if _route_fused(data):
        out = fp8_matmul(h2, weight.contiguous(), w_scale.contiguous(),
                         x_scale, bias=b, act=act, fmt=fmt)
    else:
        out = fp8_matmul_plain(h2, weight, w_scale, x_scale, b, act, fmt)
    return out.reshape(lead + (weight.shape[0],))
