"""Basic Gluon layers on the serving path.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``: ``Dense`` (weight
layout (units, in_units)), ``Embedding``, ``LayerNorm`` (parameters
``gamma``/``beta``) and ``Dropout``, with the reference's argument names.
Each creates its parameters (trainable, ``grad_req="write"``) on its
device at construction, so the input width (``in_units`` /
``in_channels``) is required: the reference's deferred shape inference is
not part of this slice. ``Dropout`` is live only while
``autograd.is_training()``, as in the reference.
"""
from __future__ import annotations

import torch

from ... import autograd
from ... import numpy_extension as npx
from ...base import MXNetError
from ...context import resolve_device
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["Dense", "Embedding", "LayerNorm", "Dropout"]


def _param(shape, dtype, device):
    """The tensor of a new trainable :class:`Parameter`, to be assigned to
    a block attribute (which registers it)."""
    return Parameter(shape, dtype, device).data()


def _width(name, value):
    if int(value) <= 0:
        raise MXNetError(f"{name} must be given (deferred shape inference "
                         "is not part of this slice of the port)")
    return int(value)


class Dense(HybridBlock):
    """Fully connected layer (reference: basic_layers.py Dense)."""

    def __init__(self, units, use_bias=True, flatten=True,
                 dtype=torch.float32, in_units=0, device=None):
        super().__init__()
        device = resolve_device(device)
        self._units = units
        self._flatten = flatten
        self.weight = _param((units, _width("in_units", in_units)), dtype,
                             device)
        self.bias = _param((units,), dtype, device) if use_bias else None

    def forward(self, x):
        return npx.fully_connected(x, self.weight, self.bias,
                                   flatten=self._flatten)

    def extra_repr(self):
        return f"{self._units}, in={self.weight.shape[1]}"


class Embedding(HybridBlock):
    """Reference: basic_layers.py Embedding over indexing_op.cc."""

    def __init__(self, input_dim, output_dim, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.weight = _param((input_dim, output_dim), dtype,
                             resolve_device(device))

    def forward(self, x):
        return npx.embedding(x, self.weight)


class LayerNorm(HybridBlock):
    """LayerNorm over the last axis (reference: basic_layers.py LayerNorm)."""

    def __init__(self, epsilon=1e-5, in_channels=0, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self._epsilon = epsilon
        width = _width("in_channels", in_channels)
        self.gamma = _param((width,), dtype, device)
        self.beta = _param((width,), dtype, device)

    def forward(self, x):
        return npx.layer_norm(x, self.gamma, self.beta, eps=self._epsilon)


class Dropout(HybridBlock):
    """Inverted dropout while ``autograd.is_training()`` (inside
    ``autograd.record()`` or ``train_mode()``), identity otherwise
    (reference: basic_layers.py Dropout). The mask comes from
    ``self.generator``, which a training caller sets; serving never
    trains."""

    def __init__(self, rate):
        super().__init__()
        self._rate = rate
        self.generator = None

    def forward(self, x):
        if not autograd.is_training() or not self._rate:
            return x
        if self.generator is None:
            raise MXNetError("Dropout in training mode needs an explicit "
                             "torch.Generator (set block.generator)")
        keep = 1.0 - self._rate
        mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
        return x * mask / keep
