"""``HybridBlock`` as an ``nn.Module``.

Counterpart of ``mxnet_tpu/gluon/block.py`` + ``gluon/parameter.py``.
Parameters are ``nn.Parameter``s created with their full shape on the
block's device at construction (the JAX package's deferred shape inference
is not needed: every layer on the serving path is told its input width).
``collect_params()`` returns the JAX package's structural names (attribute
paths, e.g. ``backbone.decoder.layer0.attention.query_proj.weight``), so
weights carry across by name. ``hybridize()`` is not part of this slice.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import initializer as _init
from .. import random as _random
from ..base import MXNetError

__all__ = ["HybridBlock"]


class HybridBlock(nn.Module):
    """Base block: a ``torch.nn.Module`` with the Gluon parameter surface.

    Blocks start in inference mode (``training`` False), as Gluon blocks
    run outside ``autograd.record(train_mode=True)``; dropout is live only
    after ``train()``."""

    def __init__(self):
        super().__init__()
        self.training = False

    def collect_params(self):
        """dict structural-name -> ``nn.Parameter`` (tied parameters once)."""
        return dict(self.named_parameters())

    @property
    def device(self):
        for p in self.parameters():
            return p.device
        raise MXNetError(f"{type(self).__name__} holds no parameters")

    @property
    def initialized(self):
        return all(getattr(p, "_mx_initialized", False)
                   for p in self.parameters())

    @torch.no_grad()
    def initialize(self, init=None, seed=0, force_reinit=False):
        """Fill every parameter on its own device, in ``collect_params``
        order, from one ``torch.Generator`` seeded with ``seed``.
        ``init`` defaults to ``Uniform(0.07)``; names ending in gamma /
        beta / bias get ones / zeros as in the JAX package."""
        init = _init.Uniform() if init is None else init
        gens = {}
        for name, p in self.collect_params().items():
            if getattr(p, "_mx_initialized", False) and not force_reinit:
                continue
            gen = gens.get(p.device)
            if gen is None:
                gen = gens[p.device] = _random.generator(seed, p.device)
            init(name, p, gen)
            p._mx_initialized = True
        return self
