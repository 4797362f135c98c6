"""``HybridBlock`` as an ``nn.Module``.

Counterpart of ``mxnet_tpu/gluon/block.py``. Each parameter is a
:class:`~.parameter.Parameter` whose tensor (an ``nn.Parameter``) is
registered on its block on the block's device at construction; a layer
told no input width gets a deferred parameter (a 0 in its shape) whose
shape its first forward finishes (``Parameter._finish_deferred_init``), as
in the JAX package.
``collect_params()`` returns ``{structural name: Parameter}`` under the
JAX package's names (attribute paths, e.g.
``backbone.decoder.layer0.attention.query_proj.weight``), so weights carry
across by name. ``copy.deepcopy(block)`` gives a block with the same
names and values on new storage (``parameter._Var``).

A block called while ``autograd`` is not recording runs under
``torch.no_grad()`` (``__call__``): as in the reference, only computation
under ``autograd.record()`` can be differentiated. A method that is not
``forward`` and reads a parameter itself, rather than through a sub-block's
call (the tied LM head's KV-cache entry points), takes the same gate through
:func:`recording_gate`. ``hybridize()`` is not part of this slice.
"""
from __future__ import annotations

import functools
import re

import torch
from torch import nn

from .. import autograd as _autograd
from .. import initializer as _init
from .. import random as _random
from ..base import MXNetError
from .parameter import Constant

__all__ = ["HybridBlock", "recording_gate"]


def recording_gate(fn):
    """Run ``fn`` under ``torch.no_grad()`` unless ``autograd`` is
    recording: what a block computes outside ``record()`` builds no
    autograd graph."""
    @functools.wraps(fn)
    def gated(*args, **kwargs):
        if not torch.is_grad_enabled() or _autograd.is_recording():
            return fn(*args, **kwargs)
        with torch.no_grad():
            return fn(*args, **kwargs)
    return gated


class HybridBlock(nn.Module):
    """Base block: a ``torch.nn.Module`` with the Gluon parameter surface.

    Dropout follows ``autograd.is_training()`` (set by ``record()`` and
    ``train_mode()``), not ``nn.Module.training``."""

    def __init__(self):
        super().__init__()
        self.training = False

    def __call__(self, *args, **kwargs):
        # recording_gate, written out: this runs for every nested block
        if torch.is_grad_enabled() and not _autograd.is_recording():
            with torch.no_grad():
                return super().__call__(*args, **kwargs)
        return super().__call__(*args, **kwargs)

    def collect_params(self, select=None):
        """dict structural-name -> :class:`Parameter` (tied parameters
        once); ``select`` keeps the names it matches from their start
        (``re.match``, e.g. ``".*weight"``), as in the reference."""
        pattern = None if select is None else re.compile(select)
        out = {}
        for name, var in self.named_parameters():
            param = var._mx_param
            param.name = name
            if pattern is None or pattern.match(name):
                out[name] = param
        return out

    def setattr(self, name, value):
        """Set attribute ``name`` (e.g. ``grad_req``, ``lr_mult``) on every
        parameter."""
        for p in self.collect_params().values():
            setattr(p, name, value)

    def cast(self, dtype):
        """Cast every parameter to ``dtype`` (a dtype or its name;
        reference: block.py ``cast``, the bf16 training path with
        ``multi_precision``); returns the block."""
        for p in self.collect_params().values():
            p.cast(dtype)
        return self

    def zero_grad(self):
        """Zero every parameter's gradient buffer in place (the reference's
        ``Block.zero_grad``)."""
        for p in self.collect_params().values():
            p.zero_grad()

    @property
    def device(self):
        for p in self.parameters():
            return p.device
        raise MXNetError(f"{type(self).__name__} holds no parameters")

    @property
    def initialized(self):
        return all(p.initialized for p in self.collect_params().values())

    @torch.no_grad()
    def initialize(self, init=None, seed=None, force_reinit=False):
        """Fill every parameter on its own device, in ``collect_params``
        order, from the default generator of that device
        (``random.default_generator``, which ``random.seed`` reseeds), as
        the reference draws from its global key stream; ``seed`` draws
        instead from one fresh ``torch.Generator`` per device seeded with
        it. ``init`` defaults to ``Uniform(0.07)``; the names get the
        JAX package's rule (``initializer.Initializer``). A parameter of
        unknown shape records the initializer and the generator and draws
        at the first forward. A :class:`~.parameter.Constant` keeps its
        value (the reference's re-initialization copies it back)."""
        init = _init.Uniform() if init is None else init
        gens = {}
        for name, p in self.collect_params().items():
            if isinstance(p, Constant) or (p.initialized
                                           and not force_reinit):
                continue
            gen = gens.get(p.device)
            if gen is None:
                gen = gens[p.device] = (
                    _random.default_generator(p.device) if seed is None
                    else _random.generator(seed, p.device))
            if not p._shape_known():
                p._deferred = (init, gen, name)
                continue
            init(name, p.data(), gen)
            p._deferred = None
            p.initialized = True
        return self
