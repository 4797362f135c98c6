"""Recurrent cells.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py`` (reference:
python/mxnet/gluon/rnn/rnn_cell.py): ``RecurrentCell`` (``unroll`` over
NTC or TNC inputs, ``merge_outputs``, ``valid_length``, ``begin_state``,
``reset``), ``RNNCell``, ``LSTMCell`` (gates i, f, g, o), ``GRUCell``
(r, z, n), ``SequentialRNNCell``, ``DropoutCell``, ``ModifierCell``,
``ResidualCell``, ``ZoneoutCell``, ``VariationalDropoutCell`` (one mask a
sequence, kept until ``reset()``), ``LSTMPCell`` and
``BidirectionalCell`` (``unroll`` only). Parameter names are the
reference's (``i2h_weight``, ``h2h_weight``, ``i2h_bias``, ``h2h_bias``,
``h2r_weight``; a ``SequentialRNNCell``'s cells under "0", "1", ...), so
``functional.load_params`` carries the JAX package's weights. An input
size of 0 defers the ``i2h_weight``'s shape to the first step.

A cell's step takes its states as a list of tensors or ``mx.np`` arrays;
``begin_state`` makes ``mx.np`` zeros on the cell's device. The dropout
masks come from the default generator of the tensor's device
(``random.dropout_mask``) while ``autograd.is_training()``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import autograd
from ... import numpy as _np
from ... import random as _random
from ...context import resolve_device
from ...numpy.multiarray import _wrap, ndarray
from ...numpy_extension import _stack
from ...numpy_extension import tensor_ops as npx
from ..block import HybridBlock
from ..nn.basic_layers import _param, _ready

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ResidualCell", "ZoneoutCell", "VariationalDropoutCell",
           "LSTMPCell", "BidirectionalCell"]


def _raw(x):
    return x._data if type(x) is ndarray else x


def _raws(states):
    if isinstance(states, (list, tuple)):
        return [_raw(s) for s in states]
    return [_raw(states)]


class RecurrentCell(HybridBlock):
    """Base of the cells: one step ``cell(x, states) -> (out, states)``,
    and :meth:`unroll` over a sequence."""

    def __init__(self):
        super().__init__()
        self._modified = False

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def _state_device(self):
        for p in self.parameters():
            return p.device
        return resolve_device(None)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states: ``func(shape, **kwargs)`` for each
        ``state_info`` entry (``mx.np.zeros`` on the cell's device by
        default)."""
        if func is None:
            func = _np.zeros
            if "ctx" not in kwargs and "device" not in kwargs:
                kwargs["device"] = self._state_device()
        return [func(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step the cell ``length`` times along the T axis of ``layout``
        (reference: rnn_cell.py ``unroll``); outputs stacked unless
        ``merge_outputs`` is False, and past each ``valid_length`` set to
        0."""
        axis = layout.find("T")
        batch = inputs.shape[layout.find("N")]
        states = self.begin_state(batch) if begin_state is None \
            else begin_state
        outputs = []
        for t in range(length):
            x = inputs[(slice(None),) * axis + (t,)]
            out, states = self(x, states)
            outputs.append(out)
        if merge_outputs is None or merge_outputs:
            outputs = _stack(outputs, axis)
        if valid_length is not None:
            from ... import numpy_extension as _npx
            outputs = _npx.sequence_mask(outputs, valid_length,
                                         use_sequence_length=True, axis=axis)
        return outputs, states

    def reset(self):
        pass


class _GateCell(RecurrentCell):
    """The dense cells' parameters: ``ngates * hidden`` rows each."""

    def __init__(self, hidden_size, ngates, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self._hidden_size = hidden_size
        self._ng = ngates
        rows = ngates * hidden_size
        self.i2h_weight = _param((rows, int(input_size)), dtype, device,
                                 init=i2h_weight_initializer)
        self.h2h_weight = _param((rows, hidden_size), dtype, device,
                                 init=h2h_weight_initializer)
        self.i2h_bias = _param((rows,), dtype, device,
                               init=i2h_bias_initializer)
        self.h2h_bias = _param((rows,), dtype, device,
                               init=h2h_bias_initializer)

    def _gates(self, x, h):
        _ready(self.i2h_weight, (self._ng * self._hidden_size, x.shape[-1]))
        return (F.linear(x, self.i2h_weight, self.i2h_bias),
                F.linear(h, self.h2h_weight, self.h2h_bias))


class RNNCell(_GateCell):
    """Elman cell: ``act(W_i x + b_i + W_h h + b_h)``."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 **kwargs):
        super().__init__(hidden_size, 1, input_size, **kwargs)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def forward(self, x, states):
        h, = _raws(states)[:1]
        i2h, h2h = self._gates(x, h)
        out = npx.activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_GateCell):
    """LSTM cell, gates i, f, g, o; states [h, c]."""

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 4, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}] * 2

    def forward(self, x, states):
        h, c = _raws(states)
        i2h, h2h = self._gates(x, h)
        i, f, g, o = (i2h + h2h).chunk(4, -1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, [h_new, c_new]


class GRUCell(_GateCell):
    """GRU cell, gates r, z, n with n = tanh(W_in x + b_in + r * (W_hn h +
    b_hn))."""

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 3, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def forward(self, x, states):
        h, = _raws(states)[:1]
        i2h, h2h = self._gates(x, h)
        xr, xz, xn = i2h.chunk(3, -1)
        hr, hz, hn = h2h.chunk(3, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1 - z) * n + z * h
        return h_new, [h_new]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in order, the states
    concatenated."""

    def add(self, cell):
        self.register_child(cell, str(len(self._modules)))

    def state_info(self, batch_size=0):
        return sum([c.state_info(batch_size) for c in self._modules.values()],
                   [])

    def begin_state(self, batch_size=0, func=None, **kwargs):
        return sum([c.begin_state(batch_size, func, **kwargs)
                    for c in self._modules.values()], [])

    def forward(self, x, states):
        states = _raws(states)
        nxt, p = [], 0
        for cell in self._modules.values():
            n = len(cell.state_info())
            x, st = cell(x, states[p:p + n])
            nxt.extend(st)
            p += n
        return x, nxt

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]


class DropoutCell(RecurrentCell):
    """Dropout on the step's input while training; no states."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = tuple(axes)

    def state_info(self, batch_size=0):
        return []

    def forward(self, x, states):
        return npx.dropout(x, p=self._rate, axes=self._axes), _raws(states) \
            if states else []


class ModifierCell(RecurrentCell):
    """Base of the cells that wrap another (its parameters are the
    wrapper's, under ``base_cell.``)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size, func, **kwargs)
        self.base_cell._modified = True
        return begin

    def reset(self):
        self.base_cell.reset()


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def forward(self, x, states):
        out, states = self.base_cell(x, _raws(states))
        return out + x, states


class ZoneoutCell(ModifierCell):
    """Zoneout (Krueger et al. 2016): while training, each output and
    state element keeps its previous value with probability
    ``zoneout_outputs`` / ``zoneout_states``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self._zo, self._zs = zoneout_outputs, zoneout_states
        self._prev = None

    def reset(self):
        super().reset()
        self._prev = None

    def forward(self, x, states):
        states = _raws(states)
        out, new_states = self.base_cell(x, states)
        if autograd.is_training():
            if self._zo > 0:
                mask = _random.dropout_mask(out, self._zo)
                prev = self._prev if self._prev is not None \
                    else torch.zeros_like(out)
                out = mask * out + (1 - mask) * prev
            if self._zs > 0:
                new_states = [m * ns + (1 - m) * os for m, ns, os in zip(
                    [_random.dropout_mask(ns, self._zs) for ns in new_states],
                    new_states, states)]
            self._prev = out
        return out, new_states


class VariationalDropoutCell(ModifierCell):
    """Variational dropout (Gal & Ghahramani 2015): one mask a sequence
    for the inputs, the first state and the outputs, drawn at the first
    step and kept until :meth:`reset` (call it between sequences)."""

    def __init__(self, base_cell, drop_inputs=0., drop_states=0.,
                 drop_outputs=0.):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.reset()

    def reset(self):
        self.base_cell.reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def forward(self, x, states):
        states = _raws(states)
        if self.drop_states and self.drop_states_mask is None:
            self.drop_states_mask = npx.dropout(torch.ones_like(states[0]),
                                                p=self.drop_states)
        if self.drop_inputs and self.drop_inputs_mask is None:
            self.drop_inputs_mask = npx.dropout(torch.ones_like(x),
                                                p=self.drop_inputs)
        if self.drop_states:
            states = [states[0] * self.drop_states_mask] + states[1:]
        if self.drop_inputs:
            x = x * self.drop_inputs_mask
        out, states = self.base_cell(x, states)
        if self.drop_outputs:
            if self.drop_outputs_mask is None:
                self.drop_outputs_mask = npx.dropout(torch.ones_like(out),
                                                     p=self.drop_outputs)
            out = out * self.drop_outputs_mask
        return out, states


class LSTMPCell(RecurrentCell):
    """LSTM with a recurrent projection ``r = W_hr h`` (Sak et al. 2014);
    states [r, c]."""

    def __init__(self, hidden_size, projection_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        rows = 4 * hidden_size
        self.i2h_weight = _param((rows, int(input_size)), dtype, device,
                                 init=i2h_weight_initializer)
        self.h2h_weight = _param((rows, projection_size), dtype, device,
                                 init=h2h_weight_initializer)
        self.h2r_weight = _param((projection_size, hidden_size), dtype,
                                 device, init=h2r_weight_initializer)
        self.i2h_bias = _param((rows,), dtype, device,
                               init=i2h_bias_initializer)
        self.h2h_bias = _param((rows,), dtype, device,
                               init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def forward(self, x, states):
        r, c = _raws(states)
        _ready(self.i2h_weight, (4 * self._hidden_size, x.shape[-1]))
        gates = F.linear(x, self.i2h_weight, self.i2h_bias) \
            + F.linear(r, self.h2h_weight, self.h2h_bias)
        i, f, g, o = gates.chunk(4, -1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        r_new = F.linear(h_new, self.h2r_weight)
        return r_new, [r_new, c_new]


class BidirectionalCell(RecurrentCell):
    """``l_cell`` forwards and ``r_cell`` backwards over the sequence,
    outputs concatenated on the last axis (``unroll`` only)."""

    def __init__(self, l_cell, r_cell):
        super().__init__()
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return self.l_cell.state_info(batch_size) + \
            self.r_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        return self.l_cell.begin_state(batch_size, func, **kwargs) + \
            self.r_cell.begin_state(batch_size, func, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import numpy_extension as _npx
        axis = layout.find("T")
        batch = inputs.shape[layout.find("N")]
        if begin_state is None:
            begin_state = self.begin_state(batch)
        nl = len(self.l_cell.state_info())
        l_out, l_states = self.l_cell.unroll(
            length, inputs, begin_state[:nl], layout, True, valid_length)
        has_len = valid_length is not None

        def rev(x):
            y = _npx.sequence_reverse(x.swapaxes(0, axis) if axis else x,
                                      valid_length, has_len)
            return y.swapaxes(0, axis) if axis else y
        r_out, r_states = self.r_cell.unroll(
            length, rev(inputs), begin_state[nl:], layout, True,
            valid_length)
        r_out = rev(r_out)
        out = torch.cat([_raw(l_out), _raw(r_out)], -1)
        return (_wrap(out) if type(l_out) is ndarray else out), \
            l_states + r_states

    def forward(self, x, states):
        raise NotImplementedError("BidirectionalCell supports unroll() only")
