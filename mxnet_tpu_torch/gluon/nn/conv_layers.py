"""Convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``: ``_Conv`` and
``Conv2D`` (weight ``(O, I/groups, *kernel)``, optional bias and
``Activation``), ``_Pooling``, ``MaxPool2D`` and ``GlobalAvgPool2D``, with
the reference's argument names and attributes (``_channels``,
``_kernel``, ``_strides``, ``_padding``, ``_dilation``, ``_groups``,
``_layout``, ``_op_name``), which ``nn.FusableSequential`` and
``contrib.quantization`` read. ``in_channels=0`` defers the weight's shape
to the first forward. The forward convolution is the library's
(``npx.convolution`` -> ``F.conv2d``), as the reference leaves it to XLA.
Conv1D/Conv3D, the transposed convolutions and the other pooling blocks
wait for later slices of the port.
"""
from __future__ import annotations

import torch

from ... import numpy_extension as npx
from ...base import MXNetError
from ...context import resolve_device
from ..block import HybridBlock
from .basic_layers import Activation, _param, _ready

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _pair(x, n):
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,) * n


class _Conv(HybridBlock):
    """N-d forward convolution (reference: conv_layers.py ``_Conv``)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, dtype=torch.float32, device=None):
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
        self._op_name = "convolution"  # the transposed ones are not ported
        self.weight = _param((channels, in_channels // groups)
                             + self._kernel, dtype, device)
        self.bias = _param((channels,), dtype, device) if use_bias else None
        self.act = Activation(activation) if activation else None

    def forward(self, x):
        in_ch = x.shape[self._layout.index("C")]
        _ready(self.weight, (self._channels, in_ch // self._groups)
               + self._kernel)
        out = npx.convolution(x, self.weight, self.bias, kernel=self._kernel,
                              stride=self._strides, dilate=self._dilation,
                              pad=self._padding, num_filter=self._channels,
                              num_group=self._groups,
                              no_bias=self.bias is None, layout=self._layout)
        return self.act(out) if self.act is not None else out

    def extra_repr(self):
        return (f"{self._channels}, kernel_size={self._kernel}, "
                f"stride={self._strides}")


class Conv2D(_Conv):
    """2-D convolution (reference: conv_layers.py Conv2D)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0,
                 dtype=torch.float32, device=None, **kwargs):
        if weight_initializer is not None or bias_initializer != "zeros":
            raise MXNetError("per-layer initializers are not part of this "
                             "slice of the port (initialize(init=...))")
        super().__init__(channels, _pair(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, dtype=dtype, device=device)


class _Pooling(HybridBlock):
    """Reference: conv_layers.py ``_Pooling`` over ``npx.pooling``."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", layout="NCHW",
                 count_include_pad=True):
        super().__init__()
        if ceil_mode:
            raise MXNetError("ceil_mode is not part of this slice of the "
                             "port")
        self._pool_size = pool_size
        self._strides = strides if strides is not None else pool_size
        self._padding = padding
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


class MaxPool2D(_Pooling):
    """Reference: conv_layers.py MaxPool2D."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size, 2),
                         _pair(strides if strides is not None else pool_size,
                               2),
                         _pair(padding, 2), ceil_mode, False, "max", layout)


class GlobalAvgPool2D(_Pooling):
    """Reference: conv_layers.py GlobalAvgPool2D."""

    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), (1, 1), (0, 0), False, True, "avg", layout)
