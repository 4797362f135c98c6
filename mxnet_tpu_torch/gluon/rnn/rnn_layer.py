"""Fused recurrent layers: ``RNN``, ``LSTM``, ``GRU``.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py`` (reference:
python/mxnet/gluon/rnn/rnn_layer.py). The parameters are the reference's,
one set per layer and direction, ``{l|r}{i}_{i2h|h2h}_{weight|bias}``, so
``functional.load_params`` carries the JAX package's weights unchanged; an
``input_size`` of 0 defers the first layer's ``i2h_weight`` to the first
forward. The forward runs ``ops/rnn.py`` on those Parameters directly
(the reference packs them into ``npx.rnn``'s flat vector first; the values
are the same): cuDNN's RNN on the card where the route takes the call,
else the loop over time; gradients reach every Parameter either way. It is
dispatched to the host planes as the reference's ``npx.rnn`` is, under
``rnn:<mode>``. As in the reference, ``dropout`` is kept and applied
nowhere (``npx.rnn`` never reads ``p``), and ``use_sequence_length`` is
accepted and ignored.
"""
from __future__ import annotations

import torch

from ... import _hooks
from ...context import resolve_device
from ...numpy.multiarray import ndarray
from ...ops import rnn as _rnn
from ..block import HybridBlock
from ..nn.basic_layers import _param, _ready

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, mode, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size=0, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", dtype=torch.float32,
                 use_sequence_length=False, device=None, **kwargs):
        super().__init__()
        assert layout in ("TNC", "NTC")
        device = resolve_device(device)
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._use_sequence_length = use_sequence_length
        rows = _rnn.GATES[mode] * hidden_size
        for i in range(num_layers):
            for j in "lr"[:self._dir]:
                in_sz = input_size if i == 0 else hidden_size * self._dir
                setattr(self, f"{j}{i}_i2h_weight",
                        _param((rows, int(in_sz)), dtype, device,
                               init=i2h_weight_initializer))
                setattr(self, f"{j}{i}_h2h_weight",
                        _param((rows, hidden_size), dtype, device,
                               init=h2h_weight_initializer))
                setattr(self, f"{j}{i}_i2h_bias",
                        _param((rows,), dtype, device,
                               init=i2h_bias_initializer))
                setattr(self, f"{j}{i}_h2h_bias",
                        _param((rows,), dtype, device,
                               init=h2h_bias_initializer))

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"}] * \
            (2 if self._mode == "lstm" else 1)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states: ``func(shape, **kwargs)`` per
        ``state_info`` entry (``mx.np.zeros`` on the layer's device by
        default)."""
        if func is None:
            from ... import numpy as _np
            func = _np.zeros
            if "ctx" not in kwargs and "device" not in kwargs:
                kwargs["device"] = self.l0_h2h_weight.device
        return [func(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def _weights(self, in_size):
        """``(wx, wh, bx, bh)`` per layer and direction, the first
        layer's ``i2h_weight`` given its shape at the first forward."""
        rows = _rnn.GATES[self._mode] * self._hidden_size
        out = []
        for i in range(self._num_layers):
            for j in "lr"[:self._dir]:
                wx = getattr(self, f"{j}{i}_i2h_weight")
                _ready(wx, (rows, in_size if i == 0
                            else self._hidden_size * self._dir))
                out.append((wx, getattr(self, f"{j}{i}_h2h_weight"),
                            getattr(self, f"{j}{i}_i2h_bias"),
                            getattr(self, f"{j}{i}_h2h_bias")))
        return out

    def _run(self, x, weights, h0, c0):
        return _rnn.rnn(x, weights, h0, c0, self._mode, self._num_layers,
                        self._dir == 2)

    def forward(self, inputs, states=None, sequence_length=None):
        if self._layout == "NTC":
            inputs = inputs.transpose(0, 1)
        weights = self._weights(inputs.shape[-1])
        skip_states = states is None
        if skip_states:
            shape = (self._num_layers * self._dir, inputs.shape[1],
                     self._hidden_size)
            states = [inputs.new_zeros(shape)] * \
                (2 if self._mode == "lstm" else 1)
        elif not isinstance(states, (list, tuple)):
            states = [states]
        states = [s._data if type(s) is ndarray else s for s in states]
        c0 = states[1] if self._mode == "lstm" else None
        args = (inputs, weights, states[0], c0)
        out, h, c = _hooks.call(self._run, f"rnn:{self._mode}", args, {}) \
            if _hooks.on else self._run(*args)
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        if skip_states:
            return out
        return out, ([h, c] if self._mode == "lstm" else [h])

    def __repr__(self):
        return (f"{type(self).__name__}({self._hidden_size}, "
                f"num_layers={self._num_layers}, "
                f"bidirectional={self._dir == 2})")


class RNN(_RNNLayer):
    """Elman RNN layer, ``activation`` "relu" or "tanh" (reference:
    rnn_layer.py RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        super().__init__(f"rnn_{activation}", hidden_size, num_layers, layout,
                         dropout, bidirectional, input_size, **kwargs)


class LSTM(_RNNLayer):
    """LSTM layer, gates i, f, g, o; states [h, c] (reference:
    rnn_layer.py LSTM)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)


class GRU(_RNNLayer):
    """GRU layer, gates r, z, n (reference: rnn_layer.py GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)
