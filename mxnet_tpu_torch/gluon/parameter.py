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
``autograd.backward``. Shapes are always known at construction: the
reference's deferred initialization is not part of this slice.
"""
from __future__ import annotations

import torch
from torch import nn

from ..base import MXNetError

__all__ = ["Parameter"]

_GRAD_REQS = ("write", "add", "null")


class Parameter:
    """A trainable tensor of a block (reference: parameter.py
    ``Parameter``)."""

    def __init__(self, shape, dtype=torch.float32, device="cpu",
                 grad_req="write", lr_mult=1.0, wd_mult=1.0):
        self._var = nn.Parameter(torch.empty(shape, dtype=dtype,
                                             device=device))
        self._var._mx_param = self
        self._grad_req = "write"
        self.grad_req = grad_req
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        #: structural name, set by ``Block.collect_params()``
        self.name = None
        self.initialized = False

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

    # -- access --------------------------------------------------------------
    def data(self, ctx=None):
        """The parameter's tensor (the ``nn.Parameter`` the block uses)."""
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
        """Copy ``data`` (tensor or array) into the parameter in place."""
        src = torch.as_tensor(data)
        if tuple(src.shape) != self.shape:
            raise MXNetError(f"set_data: shape {tuple(src.shape)} does not "
                             f"match {self.shape} of {self.name}")
        self._var.copy_(src)
        self.initialized = True

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype}, grad_req={self._grad_req})")
