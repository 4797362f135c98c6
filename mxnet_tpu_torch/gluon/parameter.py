"""gluon.Parameter.

Counterpart of ``mxnet_tpu/gluon/parameter.py``: a block's trainable tensor
with the reference's ``grad_req`` (``"write"`` by default, ``"add"``,
``"null"``), ``lr_mult``, ``wd_mult``, ``data()``, ``grad()`` and
``zero_grad()``.

The tensor itself is an ``nn.Parameter`` registered on its block, so the
block's forward and ``torch.nn.Module`` see an ordinary parameter; it
carries a back-reference to its :class:`Parameter` (``_mx_param``), which
is how ``Block.collect_params()`` and ``autograd.backward`` find the
``grad_req`` of a tensor. ``grad_req`` maps onto ``requires_grad``
(``"null"`` -> False); the write-or-add rule on ``.grad`` is applied by
``autograd.backward``.

A shape with a 0 in it is deferred, as in the reference
(``_shape_known``): the tensor is an empty placeholder of that shape,
already registered on its block, ``Block.initialize()`` records the
initializer, the generator and the structural name, and the block's first
forward calls ``_finish_deferred_init(shape)``, which gives the same
``nn.Parameter`` its full shape on its device (``.data`` is replaced, so
the block's registration holds) and draws it then.

``copy.deepcopy`` of a block copies each tensor once (tied tensors stay
tied through the memo) and gives the copy a fresh :class:`Parameter` with
the same ``grad_req``, ``lr_mult`` and ``wd_mult`` (:class:`_Var`). ``cast``
changes the tensor's dtype in place (the AMP paths: ``Block.cast``,
``amp.convert_hybrid_block``) and ``reset_ctx`` its device, each keeping the
``nn.Parameter`` object. Every replacement of the tensor's storage (those
two, and a deferred shape made known) bumps ``_storage_version``, which a
hybridized block's captured graphs read (``gluon/cached_graph.py``): an
in-place write (the Trainer, ``set_data`` on a known shape) keeps storage
and version.
:class:`Constant` is the reference's non-trainable parameter of any dtype
(the int8 weights of ``contrib.quantization``).
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from ..base import MXNetError, torch_dtype
from ..context import resolve_device

__all__ = ["Parameter", "Constant"]

_GRAD_REQS = ("write", "add", "null")


class _Var(nn.Parameter):
    """The ``nn.Parameter`` of a :class:`Parameter`. torch's deep copy
    copies the data but not the ``_mx_param`` back-reference; this one
    copies the :class:`Parameter` with it, once per tensor (the memo)."""

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        new = super().__deepcopy__(memo)
        param = copy.copy(self._mx_param)
        param._var = new
        new._mx_param = param
        memo[id(self._mx_param)] = param
        return new


class Parameter:
    """A trainable tensor of a block (reference: parameter.py
    ``Parameter``)."""

    def __init__(self, shape, dtype=torch.float32, device="cpu",
                 grad_req="write", lr_mult=1.0, wd_mult=1.0, init=None):
        self._var = _Var(torch.empty(shape, dtype=torch_dtype(dtype),
                                     device=resolve_device(device)),
                         requires_grad=False)
        self._var._mx_param = self
        self.grad_req = grad_req
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        #: this parameter's own initializer (an ``Initializer`` or its
        #: name), which ``Block.initialize`` takes before its ``init``
        self.init = init
        #: structural name, set by ``Block.collect_params()``
        self.name = None
        self.initialized = False
        #: (initializer, generator, name) of a deferred initialization
        self._deferred = None
        #: bumped whenever the tensor gets new storage (``_replace``)
        self._storage_version = 0

    # -- shape and placement ---------------------------------------------
    @property
    def shape(self):
        return tuple(self._var.shape)

    @property
    def dtype(self):
        return self._var.dtype

    @property
    def device(self):
        return self._var.device

    def _replace(self, data):
        """Give the ``nn.Parameter`` new storage ``data`` (same object, so
        the block's registration holds)."""
        self._var.data = data
        self._storage_version += 1

    def _shape_known(self):
        return all(s > 0 for s in self.shape)

    def _check_shape(self, shape):
        """Raise unless ``shape`` fills this parameter's unknown (0)
        dimensions and keeps its known ones."""
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(self.shape) or any(
                s not in (0, n) for s, n in zip(self.shape, shape)):
            raise MXNetError(f"cannot update shape {self.shape} -> {shape} "
                             f"for {self.name}")
        return shape

    @torch.no_grad()
    def _finish_deferred_init(self, shape=None):
        """Give a deferred parameter its full ``shape`` (on its device) and
        draw the initialization that ``Block.initialize()`` recorded
        (reference: parameter.py ``_finish_deferred_init``). Raises when
        the parameter was never initialized."""
        if shape is not None and tuple(shape) != self.shape:
            shape = self._check_shape(shape)
            self._replace(torch.empty(shape, dtype=self.dtype,
                                      device=self.device))
            self.initialized = False  # the new storage holds nothing yet
        if not self._shape_known():
            raise MXNetError(f"parameter {self.name} has unknown shape "
                             f"{self.shape}; run a forward pass to infer it")
        if self._deferred is None:
            if not self.initialized:
                raise MXNetError(f"parameter {self.name} not initialized; "
                                 "call .initialize() before forward")
            return
        init, generator, name = self._deferred
        init(name, self._var, generator)
        self._deferred = None
        self.initialized = True

    # -- gradient requirement ----------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in _GRAD_REQS:
            raise MXNetError(f"grad_req must be one of {_GRAD_REQS}, got "
                             f"{req!r}")
        self._grad_req = req
        self._var.requires_grad_(req != "null")
        if req == "null":
            self._var.grad = None

    @torch.no_grad()
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, device=None, generator=None):
        """Fill the parameter (reference: parameter.py ``initialize``):
        ``init``, else its own ``init``, else ``default_init``, else
        ``Uniform(0.07)`` (an initializer or its name), under its
        structural name's rule, drawn from ``generator`` or the default
        generator of its device, after moving it to ``ctx`` / ``device``
        where given. A parameter of unknown shape records the initializer
        and the generator and draws at its first forward."""
        from .. import initializer as _init
        from .. import random as _random
        if self.initialized and not force_reinit:
            return
        if ctx is not None or device is not None:
            dev = resolve_device(device if device is not None else ctx)
            if dev != self.device:
                self.reset_ctx(dev)
        chosen = init or self.init or default_init
        chosen = _init.create(chosen) if chosen is not None \
            else _init.Uniform()
        gen = generator if generator is not None \
            else _random.default_generator(self.device)
        name = self.name or "weight"
        if not self._shape_known():
            self._deferred = (chosen, gen, name)
            return
        chosen(name, self._var, gen)
        self._deferred = None
        self.initialized = True

    # -- access --------------------------------------------------------------
    def data(self, ctx=None):
        """The parameter's tensor (the ``nn.Parameter`` the block uses; a
        tensor, not an ``mx.np`` array: the kernels, the captured graphs
        and the fused update read it as one)."""
        return self._var

    def grad(self, ctx=None):
        """The gradient buffer: zeros until a backward writes it, as the
        reference's attached buffer is. Raises when ``grad_req`` is
        "null"."""
        if self._grad_req == "null":
            raise MXNetError(f"parameter {self.name} has no gradient buffer "
                             "(grad_req='null')")
        if self._var.grad is None:
            self._var.grad = torch.zeros_like(self._var)
        return self._var.grad

    def zero_grad(self):
        """Zero the gradient buffer in place (the "add" accumulator)."""
        if self._var.grad is not None:
            self._var.grad.zero_()

    @torch.no_grad()
    def set_data(self, data):
        """Copy ``data`` (an ``mx.np`` array, tensor or host array) into
        the parameter in place."""
        src = torch.as_tensor(getattr(data, "_data", data))
        if tuple(src.shape) != self.shape:
            if self._shape_known():
                raise MXNetError(f"set_data: shape {tuple(src.shape)} does "
                                 f"not match {self.shape} of {self.name}")
            self._replace(torch.empty(self._check_shape(src.shape),
                                      dtype=self.dtype, device=self.device))
        self._var.copy_(src)
        if self._shape_known():
            self._deferred = None
            self.initialized = True

    @torch.no_grad()
    def cast(self, dtype):
        """Cast the tensor to ``dtype`` (a dtype or its name; reference:
        parameter.py ``cast``) in place: the block's ``nn.Parameter`` stays
        the same object (its ``.data`` is replaced), so the block's
        registration, ``grad_req`` and anything keyed by the tensor (an
        ``amp.fp8.scope`` site map) still hold. The gradient buffer is
        dropped (zeros in the new dtype on the next ``grad()``, as the
        reference re-attaches it). A deferred parameter takes the dtype
        when its first forward gives it its shape."""
        self._replace(self._var.data.to(torch_dtype(dtype)))
        self._var.grad = None

    @torch.no_grad()
    def reset_ctx(self, ctx):
        """Move the tensor to device ``ctx`` (a ``Context``, a
        ``torch.device`` or its name; reference: parameter.py
        ``reset_ctx``), keeping the ``nn.Parameter`` object as :meth:`cast`
        does. The gradient buffer is dropped (zeros on the new device on
        the next ``grad()``, as the reference re-attaches it)."""
        self._replace(self._var.data.to(resolve_device(ctx)))
        self._var.grad = None

    reset_device = reset_ctx

    def __deepcopy__(self, memo):
        return copy.deepcopy(self._var, memo)._mx_param

    def __repr__(self):
        return (f"{type(self).__name__} {self.name} (shape={self.shape}, "
                f"dtype={self.dtype}, grad_req={self._grad_req})")


class Constant(Parameter):
    """A non-trainable parameter holding ``value`` (array or tensor, any
    dtype) on ``device`` (reference: parameter.py ``Constant``).
    ``grad_req`` is "null" and stays so; it is initialized at construction
    and ``initialize()`` leaves it as it is."""

    def __init__(self, value, name="const", device="cpu"):
        value = torch.as_tensor(value)
        super().__init__(tuple(value.shape), value.dtype, device,
                         grad_req="null")
        self.set_data(value)
        self.name = name

    @Parameter.grad_req.setter
    def grad_req(self, req):
        if req != "null":
            raise MXNetError(f"Constant {self.name} is not trainable "
                             f"(grad_req='null'), got {req!r}")
        Parameter.grad_req.fset(self, req)
