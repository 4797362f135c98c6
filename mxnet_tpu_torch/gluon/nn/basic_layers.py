"""Basic Gluon layers.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``: ``Sequential`` and
``HybridSequential`` (children registered as "0", "1", ...), ``Dense``
(weight layout (units, in_units), an optional ``Activation`` child),
``Activation``, ``Embedding``, ``LayerNorm`` (over ``axis``, parameters
``gamma``/``beta``, frozen where ``scale`` / ``center`` is off),
``GroupNorm``, ``InstanceNorm``, ``Dropout`` (``axes`` share a draw),
``BatchNorm`` (the global batch's statistics where a Trainer over a
dist store updates its parameters), ``SyncBatchNorm`` (the global batch's
statistics on more than one process; one card: BatchNorm's, as the
reference's single-device path), ``BatchNormReLU``, ``Flatten``,
``Identity``, ``Lambda`` / ``HybridLambda``, ``Concatenate`` /
``HybridConcatenate``, with the reference's argument names. Under an fp8
training scope (``amp.fp8.scope``) a ``Dense`` whose weight is a site
runs through ``amp.fp8.dense_fp8``; its activation still applies
afterwards.
Each creates its parameters on its device at construction. ``Dense`` and
``BatchNorm`` told no input width (``in_units`` / ``in_channels`` 0) get
deferred parameters, whose shape their first forward infers from the input
(:func:`_ready`), as the reference's do, and so do the norms told no
``in_channels``; ``Embedding`` still needs its widths
(``sparse_grad=True``: a row-sparse weight gradient).
``Dropout`` is live only while ``autograd.is_training()``, as in the
reference, and draws its mask from
its own ``generator`` where one is set, else from the default generator of
the tensor's device (``random.seed`` reseeds those); a dropped element is
0 whatever its value (``where(keep, x / (1 - rate), 0)``).
"""
from __future__ import annotations

import contextlib

import math

import torch

from ... import autograd
from ...amp import fp8 as _fp8
from ...numpy_extension import tensor_ops as npx
from ... import random as _random
from ...context import resolve_device
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "Embedding", "LayerNorm", "GroupNorm", "InstanceNorm", "Dropout",
           "BatchNorm", "SyncBatchNorm", "BatchNormReLU", "Flatten",
           "Identity", "Lambda", "HybridLambda", "Concatenate",
           "HybridConcatenate"]


def _param(shape, dtype, device, grad_req="write", init=None):
    """The tensor of a new :class:`Parameter` (trainable unless
    ``grad_req="null"``; deferred where ``shape`` holds a 0; ``init`` its
    own initializer), to be assigned to a block attribute (which registers
    it)."""
    return Parameter(shape, dtype, device, grad_req=grad_req,
                     init=init).data()


def _ready(var, shape):
    """Finish ``var``'s deferred shape (``shape``, from the input) and its
    deferred initialization at the block's first forward."""
    p = var._mx_param
    if p._deferred is not None or not p._shape_known():
        p._finish_deferred_init(shape)


class HybridSequential(HybridBlock):
    """Blocks run in order, each on the previous one's output (reference:
    basic_layers.py HybridSequential). ``net[i]`` reads the current child,
    so a child replaced in place (``contrib.quantization.quantize_net``)
    shows through."""

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x, *args)
            args = ()
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        blocks = list(self._modules.values())
        if isinstance(key, slice):
            net = type(self)()
            net.add(*blocks[key])
            return net
        return blocks[key]

    def __iter__(self):
        return iter(self._modules.values())


class Dense(HybridBlock):
    """Fully connected layer (reference: basic_layers.py Dense);
    ``weight_initializer`` / ``bias_initializer`` are the parameters' own
    initializers, which ``initialize()`` takes before its ``init``. Under
    tensor parallelism its weight holds this rank's block and ``_tp`` its
    role (``parallel.tp.TpRole``), which runs the product with the
    collectives the role needs."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype=torch.float32, weight_initializer=None,
                 bias_initializer="zeros", in_units=0, device=None):
        super().__init__()
        device = resolve_device(device)
        self._units = units
        self._flatten = flatten
        self.weight = _param((units, int(in_units)), dtype, device,
                             init=weight_initializer)
        self.bias = _param((units,), dtype, device, init=bias_initializer) \
            if use_bias else None
        self.act = Activation(activation) if activation else None
        #: the tensor-parallel role (``parallel.tp``), None when whole
        self._tp = None

    def _product(self, x, w, b):
        """``x @ w.T + b``: through the fp8 product where ``self.weight``
        is a site of an active fp8 scope (amp/fp8.py), else the fp32
        dense path."""
        fp8 = _fp8.current()
        site = fp8.sites.get(self.weight) if fp8 is not None else None
        if site is not None and site in fp8.scales:
            return _fp8.dense_fp8(x, w, b, site, flatten=self._flatten)
        return npx.fully_connected(x, w, b, flatten=self._flatten)

    def forward(self, x):
        _ready(self.weight, (self._units, math.prod(x.shape[1:])
                             if self._flatten else x.shape[-1]))
        if self._tp is not None:
            out = self._tp.run(self, x)
        else:
            out = self._product(x, self.weight, self.bias)
        return self.act(out) if self.act is not None else out

    def extra_repr(self):
        return f"{self._units}, in={self.weight.shape[1]}"


class Activation(HybridBlock):
    """``npx.activation`` as a block (reference: basic_layers.py
    Activation); no parameters."""

    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return npx.activation(x, act_type=self._act_type)

    def extra_repr(self):
        return self._act_type


class Embedding(HybridBlock):
    """Reference: basic_layers.py Embedding over indexing_op.cc.
    ``sparse_grad=True`` gives the weight ``grad_stype="row_sparse"``: an
    eager recorded call writes a ``RowSparseNDArray`` gradient (its rows
    only), which lazy-update optimizers and the store's row-sparse push
    take; hybridized, the gradient is dense, as in the reference."""

    def __init__(self, input_dim, output_dim, dtype=torch.float32,
                 weight_initializer=None, sparse_grad=False, device=None):
        super().__init__()
        self._sparse_grad = sparse_grad
        self.weight = Parameter(
            (input_dim, output_dim), dtype, resolve_device(device),
            init=weight_initializer,
            grad_stype="row_sparse" if sparse_grad else "default").data()

    def forward(self, x):
        return npx.embedding(x, self.weight, sparse_grad=self._sparse_grad)


class LayerNorm(HybridBlock):
    """LayerNorm over ``axis`` (reference: basic_layers.py LayerNorm);
    ``in_channels=0`` defers the parameters' shape to the first
    forward."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self._axis = axis
        self._epsilon = epsilon
        shape = (int(in_channels),)
        self.gamma = _param(shape, dtype, device,
                            "write" if scale else "null",
                            init=gamma_initializer)
        self.beta = _param(shape, dtype, device,
                           "write" if center else "null",
                           init=beta_initializer)

    def forward(self, x):
        ch = (x.shape[self._axis],)
        _ready(self.gamma, ch)
        _ready(self.beta, ch)
        return npx.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                              eps=self._epsilon)


class _ChannelNorm(HybridBlock):
    """GroupNorm / InstanceNorm: per-channel ``gamma`` / ``beta`` on axis
    1, deferred where ``in_channels`` is 0."""

    def __init__(self, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels, dtype, device):
        super().__init__()
        device = resolve_device(device)
        self._epsilon = epsilon
        shape = (int(in_channels),)
        self.gamma = _param(shape, dtype, device,
                            "write" if scale else "null",
                            init=gamma_initializer)
        self.beta = _param(shape, dtype, device,
                           "write" if center else "null",
                           init=beta_initializer)

    def _params_for(self, x):
        _ready(self.gamma, (x.shape[1],))
        _ready(self.beta, (x.shape[1],))
        return self.gamma, self.beta


class GroupNorm(_ChannelNorm):
    """Reference: basic_layers.py GroupNorm over group_norm.cc."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, dtype=torch.float32, device=None):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, dtype, device)
        self._num_groups = num_groups

    def forward(self, x):
        g, b = self._params_for(x)
        return npx.group_norm(x, g, b, num_groups=self._num_groups,
                              eps=self._epsilon)


class InstanceNorm(_ChannelNorm):
    """Reference: basic_layers.py InstanceNorm over instance_norm.cc."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, dtype=torch.float32, device=None):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, dtype, device)

    def forward(self, x):
        g, b = self._params_for(x)
        return npx.instance_norm(x, g, b, eps=self._epsilon)


class Dropout(HybridBlock):
    """Inverted dropout while ``autograd.is_training()`` (inside
    ``autograd.record()`` or ``train_mode()``), identity otherwise
    (reference: basic_layers.py Dropout); along each axis of ``axes`` one
    draw is shared. The mask comes from ``self.generator`` where a caller
    sets one, else from the default generator of the tensor's device
    (``random.dropout_mask``)."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = tuple(axes)
        self.generator = None

    def forward(self, x):
        if not autograd.is_training() or not self._rate:
            return x
        like = x
        if self._axes:
            shape = list(x.shape)
            for ax in self._axes:
                shape[ax] = 1
            like = x.new_empty(shape)
        mask = _random.dropout_mask(like, self._rate, self.generator)
        return torch.where(mask.bool(), x / (1.0 - self._rate),
                           x.new_zeros(()))


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis`` (reference: basic_layers.py
    BatchNorm over batch_norm.cc): ``gamma`` and ``beta`` trainable
    (``grad_req="null"`` where ``scale`` / ``center`` is off),
    ``running_mean`` and ``running_var`` parameters with ``grad_req="null"``
    that ``npx.batch_norm`` updates in place while training, so
    ``collect_params``, ``load_params`` and ``Trainer`` see them and the
    Trainer never updates them. ``in_channels=0`` defers their shape to
    the first forward."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, in_channels=0,
                 dtype=torch.float32, device=None, **kwargs):
        super().__init__()
        device = resolve_device(device)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        shape = (int(in_channels),)
        self.gamma = _param(shape, dtype, device,
                            "write" if scale else "null")
        self.beta = _param(shape, dtype, device,
                           "write" if center else "null")
        self.running_mean = _param(shape, dtype, device, "null")
        self.running_var = _param(shape, dtype, device, "null")

    def syncs_batch_stats(self):
        """Whether this layer trains on the global batch's statistics: its
        parameters are updated by a Trainer over a dist store on more than
        one process (which marks them)."""
        return any(getattr(v._mx_param, "_sync_batch_stats", False)
                   for v in (self.gamma, self.beta, self.running_mean,
                             self.running_var))

    def stats_scope(self):
        """The scope this layer's training forward runs in:
        ``parallel.collectives.sync_batch_stats`` where
        :meth:`syncs_batch_stats`, else nothing."""
        if not self.syncs_batch_stats():
            return contextlib.nullcontext()
        from ...parallel.collectives import sync_batch_stats
        return sync_batch_stats()

    def forward(self, x):
        ch = (x.shape[self._axis],)
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            _ready(p, ch)
        with self.stats_scope():
            return npx.batch_norm(
                x, self.gamma, self.beta, self.running_mean,
                self.running_var, eps=self._epsilon,
                momentum=self._momentum, fix_gamma=not self._scale,
                use_global_stats=self._use_global_stats, axis=self._axis)

    def extra_repr(self):
        return f"axis={self._axis}, in_channels={self.gamma.shape[0]}"


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm (reference: basic_layers.py SyncBatchNorm,
    which is BatchNorm over the global batch of a dp mesh): its training
    statistics are those of every process's batch (the per-channel sums
    summed over the process group, ``parallel.collectives``); on one
    process, the card's batch. ``num_devices`` is accepted."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", dtype=torch.float32,
                 device=None, **kwargs):
        super().__init__(1, momentum, epsilon, center, scale,
                         use_global_stats, in_channels=in_channels,
                         dtype=dtype, device=device)

    def syncs_batch_stats(self):
        from ..._dist_init import world_size
        return world_size() > 1


class BatchNormReLU(BatchNorm):
    """BatchNorm then ReLU (reference: basic_layers.py BatchNormReLU)."""

    def forward(self, x):
        return torch.relu(super().forward(x))


class Flatten(HybridBlock):
    """(N, ...) -> (N, prod(...)) (reference: basic_layers.py Flatten)."""

    def forward(self, x):
        return npx.flatten(x)


class Sequential(HybridSequential):
    """Blocks run in order (reference: basic_layers.py Sequential, a
    ``Block``): ``hybridize()`` reaches its children, not itself."""

    def hybridize(self, active=True, **kwargs):
        for block in self._modules.values():
            block.hybridize(active, **kwargs)


class HybridConcatenate(HybridSequential):
    """Every child on the same input, outputs concatenated along ``axis``
    (reference: basic_layers.py HybridConcatenate)."""

    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return torch.cat([block(x) for block in self._modules.values()],
                         dim=self._axis)


class Concatenate(HybridConcatenate):
    """``HybridConcatenate`` as a ``Block`` (reference: basic_layers.py
    Concatenate): ``hybridize()`` reaches its children, not itself."""

    hybridize = Sequential.hybridize


class Identity(HybridBlock):
    """Its input (reference: basic_layers.py Identity)."""

    def forward(self, x):
        return x


class HybridLambda(HybridBlock):
    """A function as a block: a callable, or the name of an ``mx.np``
    function (reference: basic_layers.py HybridLambda)."""

    def __init__(self, function):
        super().__init__()
        if isinstance(function, str):
            from ... import numpy as _np
            function = getattr(_np, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class Lambda(HybridLambda):
    """``HybridLambda`` as a ``Block`` (reference: basic_layers.py
    Lambda): ``hybridize()`` leaves it eager."""

    def hybridize(self, active=True, **kwargs):
        pass
