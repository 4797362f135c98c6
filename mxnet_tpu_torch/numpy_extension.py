"""The ``npx`` operators on the serving path, as plain PyTorch.

Counterpart of ``mxnet_tpu/numpy_extension/__init__.py`` (fully_connected,
layer_norm, exact-erf gelu, embedding); the rest of that module waits for
later slices of the port.
"""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["fully_connected", "layer_norm", "gelu", "embedding"]


def fully_connected(x, weight, bias=None, flatten=True):
    """``x @ weight.T + bias`` with weight layout (units, in_units)
    (reference: src/operator/nn/fully_connected.cc)."""
    if flatten:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x, weight, bias)


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis (reference: layer_norm.cc)."""
    return F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)


def gelu(x):
    """Exact (erf) GELU, as ``npx.leaky_relu(act_type="gelu")`` computes
    it (``approximate=False``)."""
    return F.gelu(x, approximate="none")


def embedding(ids, weight):
    """Row gather ``weight[ids]`` (reference: indexing_op.cc Embedding)."""
    return F.embedding(ids.long(), weight)
