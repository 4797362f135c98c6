"""Parameter initializers.

Counterpart of ``mxnet_tpu/initializer.py``: the same name dispatch
(``gamma`` -> ones, ``beta``/``bias`` -> zeros, everything else the
initializer's own rule) and the same default, ``Uniform(0.07)``. Samples
are drawn from an explicit ``torch.Generator`` on the parameter's device.
"""
from __future__ import annotations

import torch

__all__ = ["Initializer", "Uniform", "Zero", "One"]


class Initializer:
    """Base initializer: ``init(name, tensor, generator)`` fills in place."""

    @torch.no_grad()
    def __call__(self, name, arr, generator):
        if name.endswith("gamma"):
            arr.fill_(1.0)
        elif name.endswith(("beta", "bias")):
            arr.zero_()
        else:
            self._init_weight(arr, generator)

    def _init_weight(self, arr, generator):
        raise NotImplementedError


class Zero(Initializer):
    def _init_weight(self, arr, generator):
        arr.zero_()


class One(Initializer):
    def _init_weight(self, arr, generator):
        arr.fill_(1.0)


class Uniform(Initializer):
    """U(-scale, scale); the JAX package's default parameter initializer
    (``gluon/parameter.py`` falls back to ``Uniform()``)."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, arr, generator):
        arr.uniform_(-self.scale, self.scale, generator=generator)

    def __repr__(self):
        return f"Uniform(scale={self.scale})"
