"""The ``npx`` operators on the ported paths, as plain PyTorch.

Counterpart of ``mxnet_tpu/numpy_extension/__init__.py`` (fully_connected,
layer_norm, activation, leaky_relu, exact-erf gelu, embedding); the rest
of that module waits for later slices of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import MXNetError

__all__ = ["fully_connected", "layer_norm", "activation", "leaky_relu",
           "gelu", "embedding"]

# the JAX package's ``_ACTS`` table; its "gelu" is jax.nn.gelu's default,
# the tanh approximation
_ACTS = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "log_sigmoid": F.logsigmoid,
    "mish": F.mish,
}


def fully_connected(x, weight, bias=None, flatten=True):
    """``x @ weight.T + bias`` with weight layout (units, in_units)
    (reference: src/operator/nn/fully_connected.cc)."""
    if flatten:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x, weight, bias)


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis (reference: layer_norm.cc)."""
    return F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)


def activation(data, act_type="relu"):
    """Reference: src/operator/nn/activation.cc."""
    if act_type not in _ACTS:
        raise MXNetError(f"unknown act_type {act_type!r}")
    return _ACTS[act_type](data)


def leaky_relu(data, act_type="leaky", slope=0.25):
    """Reference: src/operator/leaky_relu.cc, the ``leaky`` and ``gelu``
    (exact erf) act types; the others wait for a later slice."""
    if act_type == "leaky":
        return F.leaky_relu(data, slope)
    if act_type == "gelu":
        return gelu(data)
    raise MXNetError(f"leaky_relu act_type {act_type!r} is not part of "
                     "this slice of the port")


def gelu(x):
    """Exact (erf) GELU, as ``npx.leaky_relu(act_type="gelu")`` computes
    it (``approximate=False``)."""
    return F.gelu(x, approximate="none")


def embedding(ids, weight):
    """Row gather ``weight[ids]`` (reference: indexing_op.cc Embedding)."""
    return F.embedding(ids.long(), weight)
