"""Convolutional recurrent cells: ``Conv{1,2,3}D{RNN,LSTM,GRU}Cell``.

Counterpart of ``mxnet_tpu/gluon/rnn/conv_rnn_cell.py`` (reference:
python/mxnet/gluon/rnn/conv_rnn_cell.py): the dense cells' gates with
convolutions for products, channel-first layouts. The ``h2h``
convolution pads to keep the state's spatial shape, so its kernel must be
odd, as the reference requires (an even ``h2h_kernel`` raises
``ValueError``). ``i2h`` takes ``i2h_pad`` / ``i2h_dilate`` and sets the
state's spatial shape from ``input_shape`` (C, *spatial).
"""
from __future__ import annotations

import torch

from ...context import resolve_device
from ...numpy_extension import tensor_ops as npx
from ..nn.basic_layers import _param
from .rnn_cell import RecurrentCell, _raws

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _BaseConvRNNCell(RecurrentCell):
    """The conv gates (reference: conv_rnn_cell.py _BaseConvRNNCell)."""

    _ngates = 1
    _n_states = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, dims, conv_layout, activation,
                 dtype=torch.float32, device=None):
        super().__init__()
        if conv_layout not in ("NCW", "NCHW", "NCDHW"):
            raise ValueError(f"unsupported conv_layout {conv_layout!r} "
                             "(channel-first only)")
        device = resolve_device(device)
        self._hidden_channels = hidden_channels
        self._input_shape = tuple(input_shape)
        self._conv_layout = conv_layout
        self._activation = activation
        self._i2h_kernel = _tup(i2h_kernel, dims)
        self._i2h_pad = _tup(i2h_pad, dims)
        self._i2h_dilate = _tup(i2h_dilate, dims)
        self._h2h_kernel = _tup(h2h_kernel, dims)
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise ValueError(f"h2h_kernel must be odd, got {h2h_kernel}")
        self._h2h_dilate = _tup(h2h_dilate, dims)
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))
        spatial = tuple(s + 2 * p - (dl * (k - 1) + 1) + 1 for s, k, p, dl in
                        zip(self._input_shape[1:], self._i2h_kernel,
                            self._i2h_pad, self._i2h_dilate))
        self._state_shape = (hidden_channels,) + spatial
        total = self._ngates * hidden_channels
        self.i2h_weight = _param(
            (total, self._input_shape[0]) + self._i2h_kernel, dtype, device,
            init=i2h_weight_initializer)
        self.h2h_weight = _param(
            (total, hidden_channels) + self._h2h_kernel, dtype, device,
            init=h2h_weight_initializer)
        self.i2h_bias = _param((total,), dtype, device,
                               init=i2h_bias_initializer)
        self.h2h_bias = _param((total,), dtype, device,
                               init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": self._conv_layout}] * self._n_states

    def _convs(self, x, h):
        nf = self._ngates * self._hidden_channels
        i2h = npx.convolution(x, self.i2h_weight, self.i2h_bias,
                              kernel=self._i2h_kernel, pad=self._i2h_pad,
                              dilate=self._i2h_dilate, num_filter=nf,
                              layout=self._conv_layout)
        h2h = npx.convolution(h, self.h2h_weight, self.h2h_bias,
                              kernel=self._h2h_kernel, pad=self._h2h_pad,
                              dilate=self._h2h_dilate, num_filter=nf,
                              layout=self._conv_layout)
        return i2h, h2h

    def _act(self, x):
        return npx.activation(x, act_type=self._activation)

    def __repr__(self):
        return (f"{type(self).__name__}({self._input_shape[0]} -> "
                f"{self._hidden_channels}, i2h_kernel={self._i2h_kernel})")


class _ConvRNNCell(_BaseConvRNNCell):
    def forward(self, x, states):
        i2h, h2h = self._convs(x, _raws(states)[0])
        out = self._act(i2h + h2h)
        return out, [out]


class _ConvLSTMCell(_BaseConvRNNCell):
    _ngates = 4
    _n_states = 2

    def forward(self, x, states):
        h, c = _raws(states)
        i2h, h2h = self._convs(x, h)
        i, f, g, o = (i2h + h2h).chunk(4, 1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * self._act(g)
        h_new = torch.sigmoid(o) * self._act(c_new)
        return h_new, [h_new, c_new]


class _ConvGRUCell(_BaseConvRNNCell):
    _ngates = 3

    def forward(self, x, states):
        h = _raws(states)[0]
        i2h, h2h = self._convs(x, h)
        xr, xz, xn = i2h.chunk(3, 1)
        hr, hz, hn = h2h.chunk(3, 1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = self._act(xn + r * hn)
        h_new = (1 - z) * n + z * h
        return h_new, [h_new]


def _make_cell(base, name, dims, layout, doc):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 conv_layout=layout, activation="tanh", dtype=torch.float32,
                 device=None):
        base.__init__(self, input_shape, hidden_channels, i2h_kernel,
                      h2h_kernel, i2h_pad, i2h_dilate, h2h_dilate,
                      i2h_weight_initializer, h2h_weight_initializer,
                      i2h_bias_initializer, h2h_bias_initializer, dims,
                      conv_layout, activation, dtype, device)
    return type(name, (base,), {"__init__": __init__, "__doc__": doc,
                                "__module__": __name__})


Conv1DRNNCell = _make_cell(_ConvRNNCell, "Conv1DRNNCell", 1, "NCW",
                           "1D conv RNN cell.")
Conv2DRNNCell = _make_cell(_ConvRNNCell, "Conv2DRNNCell", 2, "NCHW",
                           "2D conv RNN cell.")
Conv3DRNNCell = _make_cell(_ConvRNNCell, "Conv3DRNNCell", 3, "NCDHW",
                           "3D conv RNN cell.")
Conv1DLSTMCell = _make_cell(_ConvLSTMCell, "Conv1DLSTMCell", 1, "NCW",
                            "1D ConvLSTM cell (Shi et al. 2015).")
Conv2DLSTMCell = _make_cell(_ConvLSTMCell, "Conv2DLSTMCell", 2, "NCHW",
                            "2D ConvLSTM cell (Shi et al. 2015).")
Conv3DLSTMCell = _make_cell(_ConvLSTMCell, "Conv3DLSTMCell", 3, "NCDHW",
                            "3D ConvLSTM cell (Shi et al. 2015).")
Conv1DGRUCell = _make_cell(_ConvGRUCell, "Conv1DGRUCell", 1, "NCW",
                           "1D conv GRU cell.")
Conv2DGRUCell = _make_cell(_ConvGRUCell, "Conv2DGRUCell", 2, "NCHW",
                           "2D conv GRU cell.")
Conv3DGRUCell = _make_cell(_ConvGRUCell, "Conv3DGRUCell", 3, "NCDHW",
                           "3D conv GRU cell.")
