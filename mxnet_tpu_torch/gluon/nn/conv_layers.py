"""Convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``: ``_Conv`` and
``Conv1D`` / ``Conv2D`` / ``Conv3D`` (weight ``(O, I/groups, *kernel)``,
optional bias and ``Activation``), the transposed ``Conv1DTranspose`` /
``Conv2DTranspose`` / ``Conv3DTranspose`` (weight ``(I, O/groups,
*kernel)``, ``output_padding``), ``_Pooling`` with Max / Avg (with
``count_include_pad``) / GlobalMax / GlobalAvg pooling in 1-3 dimensions,
``ReflectionPad2D``, ``DeformableConvolution`` /
``ModulatedDeformableConvolution`` (``ops/deformable.py``) and
``PixelShuffle1D`` / ``2D`` / ``3D``, with the reference's argument
names and attributes (``_channels``, ``_kernel``, ``_strides``,
``_padding``, ``_dilation``, ``_groups``, ``_layout``, ``_op_name``),
which ``nn.FusableSequential`` and ``contrib.quantization`` read.
``in_channels=0`` defers the weight's shape to the first forward. The
convolutions are the library's (``npx.convolution`` / ``deconvolution``),
as the reference leaves them to XLA. ``ceil_mode`` is accepted and, as in
the reference (whose pooling reads it nowhere), the windows are the
"valid" ones.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...numpy_extension import tensor_ops as npx
from ...base import MXNetError
from ...context import resolve_device
from ..block import HybridBlock
from .basic_layers import Activation, _param, _ready

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D", "DeformableConvolution",
           "ModulatedDeformableConvolution", "PixelShuffle1D",
           "PixelShuffle2D", "PixelShuffle3D"]


def _pair(x, n):
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,) * n


class _Conv(HybridBlock):
    """N-d forward convolution (reference: conv_layers.py ``_Conv``)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="convolution", adj=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        ndim = len(kernel_size)
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = tuple(kernel_size)
        self._strides = _pair(strides, ndim)
        self._padding = _pair(padding, ndim)
        self._dilation = _pair(dilation, ndim)
        self._groups = groups
        self._layout = layout
        self._op_name = op_name
        self._adj = adj
        self.weight = _param(self._weight_shape(in_channels), dtype, device,
                             init=weight_initializer)
        self.bias = _param((channels,), dtype, device,
                           init=bias_initializer) if use_bias else None
        self.act = Activation(activation) if activation else None

    def _weight_shape(self, in_channels):
        if self._op_name == "convolution":
            return (self._channels, in_channels // self._groups) \
                + self._kernel
        return (in_channels, self._channels // self._groups) + self._kernel

    def forward(self, x):
        _ready(self.weight,
               self._weight_shape(x.shape[self._layout.index("C")]))
        kw = dict(kernel=self._kernel, stride=self._strides,
                  dilate=self._dilation, pad=self._padding,
                  num_filter=self._channels, num_group=self._groups,
                  no_bias=self.bias is None, layout=self._layout)
        if self._op_name == "convolution":
            out = npx.convolution(x, self.weight, self.bias, **kw)
        else:
            out = npx.deconvolution(x, self.weight, self.bias, adj=self._adj,
                                    **kw)
        return self.act(out) if self.act is not None else out

    def extra_repr(self):
        return (f"{self._channels}, kernel_size={self._kernel}, "
                f"stride={self._strides}")


class Conv1D(_Conv):
    """1-D convolution (reference: conv_layers.py Conv1D)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0,
                 dtype=torch.float32, device=None, **kwargs):
        super().__init__(channels, _pair(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         dtype=dtype, device=device)


class Conv3D(_Conv):
    """3-D convolution (reference: conv_layers.py Conv3D)."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, dtype=torch.float32, device=None, **kwargs):
        super().__init__(channels, _pair(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         dtype=dtype, device=device)


class Conv1DTranspose(_Conv):
    """1-D transposed convolution (reference: conv_layers.py
    Conv1DTranspose)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0,
                 dtype=torch.float32, device=None, **kwargs):
        super().__init__(channels, _pair(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="deconvolution",
                         adj=_pair(output_padding, 1), dtype=dtype,
                         device=device)


class Conv2DTranspose(_Conv):
    """2-D transposed convolution (reference: conv_layers.py
    Conv2DTranspose)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, dtype=torch.float32, device=None, **kwargs):
        super().__init__(channels, _pair(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="deconvolution",
                         adj=_pair(output_padding, 2), dtype=dtype,
                         device=device)


class Conv3DTranspose(_Conv):
    """3-D transposed convolution (reference: conv_layers.py
    Conv3DTranspose)."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0,
                 dtype=torch.float32, device=None, **kwargs):
        super().__init__(channels, _pair(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         op_name="deconvolution",
                         adj=_pair(output_padding, 3), dtype=dtype,
                         device=device)


class Conv2D(_Conv):
    """2-D convolution (reference: conv_layers.py Conv2D)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0,
                 dtype=torch.float32, device=None, **kwargs):
        super().__init__(channels, _pair(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         dtype=dtype, device=device)


class _Pooling(HybridBlock):
    """Reference: conv_layers.py ``_Pooling`` over ``npx.pooling``;
    ``ceil_mode`` is kept and, as there, not read."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", layout="NCHW",
                 count_include_pad=True):
        super().__init__()
        self._pool_size = pool_size
        self._strides = strides if strides is not None else pool_size
        self._padding = padding
        self._ceil_mode = ceil_mode
        self._global = global_pool
        self._pool_type = pool_type
        self._layout = layout
        self._count_include_pad = count_include_pad

    def forward(self, x):
        return npx.pooling(
            x, kernel=self._pool_size, stride=self._strides,
            pad=self._padding, pool_type=self._pool_type,
            global_pool=self._global, layout=self._layout,
            count_include_pad=self._count_include_pad)

    def extra_repr(self):
        return (f"size={self._pool_size}, stride={self._strides}, "
                f"padding={self._padding}")


def _pool_class(name, nd, pool_type, layout):
    """``MaxPool{nd}D`` / ``AvgPool{nd}D`` with the reference's
    signature."""

    def __init__(self, pool_size=2, strides=None, padding=0, layout=layout,
                 ceil_mode=False, count_include_pad=True, **kwargs):
        _Pooling.__init__(
            self, _pair(pool_size, nd),
            _pair(strides if strides is not None else pool_size, nd),
            _pair(padding, nd), ceil_mode, False, pool_type, layout,
            count_include_pad)

    return type(name, (_Pooling,), {
        "__init__": __init__,
        "__doc__": f"{nd}-D {pool_type} pooling (reference: "
                   f"conv_layers.py {name})."})


def _global_pool_class(name, nd, pool_type, layout):
    def __init__(self, layout=layout, **kwargs):
        _Pooling.__init__(self, (1,) * nd, (1,) * nd, (0,) * nd, False,
                          True, pool_type, layout)

    return type(name, (_Pooling,), {
        "__init__": __init__,
        "__doc__": f"Global {pool_type} pooling over {nd} axes "
                   f"(reference: conv_layers.py {name})."})


_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}
MaxPool1D, MaxPool2D, MaxPool3D = (
    _pool_class(f"MaxPool{n}D", n, "max", _LAYOUTS[n]) for n in (1, 2, 3))
AvgPool1D, AvgPool2D, AvgPool3D = (
    _pool_class(f"AvgPool{n}D", n, "avg", _LAYOUTS[n]) for n in (1, 2, 3))
GlobalMaxPool1D, GlobalMaxPool2D, GlobalMaxPool3D = (
    _global_pool_class(f"GlobalMaxPool{n}D", n, "max", _LAYOUTS[n])
    for n in (1, 2, 3))
GlobalAvgPool1D, GlobalAvgPool2D, GlobalAvgPool3D = (
    _global_pool_class(f"GlobalAvgPool{n}D", n, "avg", _LAYOUTS[n])
    for n in (1, 2, 3))


class ReflectionPad2D(HybridBlock):
    """Reflection padding of H and W (reference: conv_layers.py
    ``ReflectionPad2D``): an int pads all four sides, four values are
    (top, bottom, left, right)."""

    def __init__(self, padding=0):
        super().__init__()
        self._padding = _pair(padding, 4)

    def forward(self, x):
        p = self._padding
        if len(p) == 2:
            p = (p[0], p[0], p[1], p[1])
        return F.pad(x, (p[2], p[3], p[0], p[1]), mode="reflect")


class DeformableConvolution(HybridBlock):
    """2-D deformable convolution (DCN v1; v2 with ``modulated``;
    reference: conv_layers.py ``DeformableConvolution``): an offset
    convolution (and for v2 a sigmoid mask times 2) feeds
    ``npx.deformable_convolution``. NCHW only."""

    def __init__(self, channels, kernel_size=(1, 1), strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1,
                 num_deformable_group=1, layout="NCHW", use_bias=True,
                 in_channels=0, activation=None, weight_initializer=None,
                 bias_initializer="zeros",
                 offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", offset_use_bias=True,
                 modulated=False, dtype=torch.float32, device=None):
        super().__init__()
        if layout != "NCHW":
            raise ValueError("DeformableConvolution supports NCHW only")
        device = resolve_device(device)
        self._channels = channels
        self._kernel = _pair(kernel_size, 2)
        self._strides = _pair(strides, 2)
        self._padding = _pair(padding, 2)
        self._dilation = _pair(dilation, 2)
        self._groups = groups
        self._ndg = num_deformable_group
        self._modulated = modulated
        taps = self._kernel[0] * self._kernel[1]
        self._offset_split = 2 * taps * num_deformable_group
        self._offset_channels = (3 if modulated else 2) * taps \
            * num_deformable_group
        wshape = (in_channels // groups,) + self._kernel
        self.offset_weight = _param((self._offset_channels,) + wshape, dtype,
                                    device, init=offset_weight_initializer)
        self.offset_bias = _param((self._offset_channels,), dtype, device,
                                  init=offset_bias_initializer) \
            if offset_use_bias else None
        self.deformable_conv_weight = _param((channels,) + wshape, dtype,
                                             device, init=weight_initializer)
        self.deformable_conv_bias = _param((channels,), dtype, device,
                                           init=bias_initializer) \
            if use_bias else None
        self.act = Activation(activation) if activation else None

    def forward(self, x):
        wshape = (x.shape[1] // self._groups,) + self._kernel
        _ready(self.offset_weight, (self._offset_channels,) + wshape)
        _ready(self.deformable_conv_weight, (self._channels,) + wshape)
        conv = dict(kernel=self._kernel, stride=self._strides,
                    pad=self._padding, dilate=self._dilation,
                    num_group=self._groups)
        off = npx.convolution(x, self.offset_weight, self.offset_bias,
                              num_filter=self._offset_channels,
                              no_bias=self.offset_bias is None,
                              layout="NCHW", **conv)
        b = self.deformable_conv_bias
        if self._modulated:
            mask = torch.sigmoid(off[:, self._offset_split:]) * 2
            out = npx.modulated_deformable_convolution(
                x, off[:, :self._offset_split], mask,
                self.deformable_conv_weight, b, num_filter=self._channels,
                no_bias=b is None, num_deformable_group=self._ndg, **conv)
        else:
            out = npx.deformable_convolution(
                x, off, self.deformable_conv_weight, b,
                num_filter=self._channels, no_bias=b is None,
                num_deformable_group=self._ndg, **conv)
        return self.act(out) if self.act is not None else out

    def extra_repr(self):
        return (f"{self._channels}, kernel_size={self._kernel}, "
                f"stride={self._strides}, "
                f"num_deformable_group={self._ndg}")


class ModulatedDeformableConvolution(DeformableConvolution):
    """DCN v2 (reference: conv_layers.py
    ``ModulatedDeformableConvolution``): the offset convolution also
    gives a mask (3 * K * ndg channels)."""

    def __init__(self, channels, kernel_size=(1, 1), strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1,
                 num_deformable_group=1, layout="NCHW", use_bias=True,
                 in_channels=0, activation=None, weight_initializer=None,
                 bias_initializer="zeros",
                 offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", offset_use_bias=True,
                 dtype=torch.float32, device=None):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, num_deformable_group, layout, use_bias,
                         in_channels, activation, weight_initializer,
                         bias_initializer, offset_weight_initializer,
                         offset_bias_initializer, offset_use_bias,
                         modulated=True, dtype=dtype, device=device)


class _PixelShuffle(HybridBlock):
    """(N, C * prod(f), *S) -> (N, C, *(S * f)) (reference:
    conv_layers.py ``PixelShuffle1D/2D/3D``)."""

    def __init__(self, factor, nd):
        super().__init__()
        self._factors = tuple(int(f) for f in _pair(factor, nd))

    def forward(self, x):
        fs, nd = self._factors, len(self._factors)
        n, c = x.shape[:2]
        sp = x.shape[2:]
        co = c // math.prod(fs)
        x = x.reshape((n, co) + fs + tuple(sp))
        # (N, C, f1..fk, S1..Sk) -> (N, C, S1, f1, ..., Sk, fk)
        order = [0, 1] + [a for i in range(nd) for a in (2 + nd + i, 2 + i)]
        return x.permute(order).reshape(
            (n, co) + tuple(s * f for s, f in zip(sp, fs)))

    def extra_repr(self):
        return str(self._factors)


class PixelShuffle1D(_PixelShuffle):
    def __init__(self, factor):
        super().__init__(factor, 1)


class PixelShuffle2D(_PixelShuffle):
    def __init__(self, factor):
        super().__init__(factor, 2)


class PixelShuffle3D(_PixelShuffle):
    def __init__(self, factor):
        super().__init__(factor, 3)
