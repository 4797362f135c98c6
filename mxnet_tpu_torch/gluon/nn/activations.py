"""Activation blocks.

Counterpart of ``mxnet_tpu/gluon/nn/activations.py``: ``Activation`` (from
``basic_layers``), ``LeakyReLU``, ``PReLU`` (a learned slope, one value
or one per channel), ``ELU``, ``SELU``, ``GELU`` (exact erf, or
``approximation="tanh"``; the JAX package always takes erf), ``SiLU`` and
``Swish``, each over the reference's ``npx`` op.
"""
from __future__ import annotations

import torch

from ...context import resolve_device
from ...numpy_extension import tensor_ops as npx
from ..block import HybridBlock
from .basic_layers import Activation, _param

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU",
           "SiLU", "Swish"]


class LeakyReLU(HybridBlock):
    """``x`` above 0, ``alpha * x`` below (reference: activations.py
    ``LeakyReLU``)."""

    def __init__(self, alpha=0.01):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return npx.leaky_relu(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope ``alpha`` of ``in_channels`` values
    (one per channel of axis 1 when above 1) (reference: activations.py
    ``PReLU``)."""

    def __init__(self, alpha_initializer="zeros", in_channels=1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.alpha = _param((in_channels,), dtype, resolve_device(device),
                            init=alpha_initializer)

    def forward(self, x):
        return npx.leaky_relu(x, self.alpha, act_type="prelu")


class ELU(HybridBlock):
    """Exponential linear unit (reference: activations.py ``ELU``)."""

    def __init__(self, alpha=1.0):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return npx.leaky_relu(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled ELU (reference: activations.py ``SELU``)."""

    def forward(self, x):
        return npx.leaky_relu(x, act_type="selu")


class GELU(HybridBlock):
    """Gaussian error linear unit (reference: activations.py ``GELU``):
    exact ("erf") or the tanh approximation ("tanh")."""

    def __init__(self, approximation="erf"):
        super().__init__()
        self._approx = approximation

    def forward(self, x):
        if self._approx == "erf":
            return npx.leaky_relu(x, act_type="gelu")
        return npx.gelu(x, approximation=self._approx)


class SiLU(HybridBlock):
    """``x * sigmoid(x)`` (reference: activations.py ``SiLU``)."""

    def forward(self, x):
        return npx.activation(x, act_type="silu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)`` (reference: activations.py ``Swish``)."""

    def __init__(self, beta=1.0):
        super().__init__()
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(x * self._beta)
