"""``gluon.contrib.nn``: ``HybridConcurrent`` / ``Concurrent``,
``Identity`` and ``SparseEmbedding``.

Counterpart of ``mxnet_tpu/gluon/contrib/nn/__init__.py`` (reference:
python/mxnet/gluon/contrib/nn/basic_layers.py). ``SparseEmbedding`` takes
dense gradients, as in the reference.
"""
from __future__ import annotations

import torch

from ... import nn as _nn
from ...block import HybridBlock

__all__ = ["HybridConcurrent", "Concurrent", "Identity", "SparseEmbedding"]


class HybridConcurrent(HybridBlock):
    """Every child on the same input, outputs concatenated along
    ``axis`` (children registered as "0", "1", ...)."""

    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def forward(self, x):
        return torch.cat([b(x) for b in self._modules.values()],
                         dim=self._axis)


class Concurrent(HybridConcurrent):
    """``HybridConcurrent`` (reference: contrib/nn Concurrent)."""


class Identity(HybridBlock):
    """Its input."""

    def forward(self, x):
        return x


class SparseEmbedding(_nn.Embedding):
    """``nn.Embedding`` with dense gradients (reference: contrib/nn
    SparseEmbedding, whose gradients are dense there too)."""
