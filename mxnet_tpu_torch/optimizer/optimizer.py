"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py`` for the training
slice: the ``Optimizer`` base (rescale_grad, clip_gradient, wd,
lr_scheduler, per-index update counts, lr_mult / wd_mult), ``SGD`` (with
momentum), ``Adam`` and ``AdamW``, the registry (``register``/``create``)
and ``Updater``/``get_updater``.

The update rules are the reference's arithmetic (not ``torch.optim``'s):

- ``Adam`` adds ``wd * w`` into the gradient and applies
  ``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` to ``m / (sqrt(v) + eps)``
  (eps not bias-corrected);
- ``AdamW`` decouples the decay: ``w -= lr * (mhat / (sqrt(vhat) + eps)
  + wd * w)``;
- ``clip_gradient`` clips elementwise after rescaling, only where it is a
  number above 0 (None, 0, a negative value and NaN mean no clipping, as
  the reference's ``clip == clip and clip > 0`` over ``clip_gradient or
  -1.0``);
- ``t`` is the parameter's own update count (the optimizer's
  ``num_update`` for a functional step that calls ``_update_impl``).

They run as plain PyTorch in place on the weight and state tensors (the
reference runs them as one XLA program per step; no Pallas kernel is
involved). ``SGD``, ``Adam`` and ``AdamW`` (``_FUSED_FAMILY`` "sgd" /
"adam", as in the reference) also carry each rule over lists of tensors
(``_update_multi``): the same ops in the same order as ``torch._foreach_*``
calls, which ``gluon.Trainer``'s ``_FusedUpdate`` runs for many
parameters at once.

``multi_precision=True`` (reference: optimizer.py:136-141, 177-195) keeps
an fp32 master copy of every fp16 or bf16 weight: the state is the tuple
``(master, inner)``, ``inner`` the rule's own state made from the master
(fp32), the rule runs on the master with the gradient widened to fp32, and
the weight receives the master rounded to its dtype. ``Updater`` calls
``create_state_multi_precision`` and ``update_multi_precision``; its state
arrays keep the master and its state in fp32 when they are saved and
loaded.
"""
from __future__ import annotations

import copy
import math
import pickle

import numpy as onp
import torch

from ..base import MXNetError

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "Updater", "register",
           "create", "get_updater"]

_registry: dict[str, type] = {}


def register(klass):
    """Register an optimizer class under its lower-cased name."""
    _registry[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by registered name (case-insensitive)."""
    klass = _registry.get(str(name).lower())
    if klass is None:
        raise MXNetError(f"unknown optimizer {name!r} (registered: "
                         f"{sorted(_registry)})")
    return klass(**kwargs)


class Optimizer:
    """Base optimizer (reference: optimizer.py ``Optimizer``)."""

    #: the multi-tensor family ("sgd", "adam") whose lists
    #: ``gluon.Trainer`` may update at once through ``_update_multi``
    _FUSED_FAMILY = None

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False, param_dict=None,
                 **kwargs):
        self.multi_precision = multi_precision
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.param_dict = param_dict or {}
        self.idx2name = param_idx2name or {}
        self.lr_mult = {}
        self.wd_mult = {}

    # -- bookkeeping (reference: _update_count / _get_lr / _get_wd) ---------
    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        p = self.param_dict.get(index)
        if p is not None:
            lr *= p.lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        p = self.param_dict.get(index)
        if p is not None:
            wd *= p.wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            self.lr_scheduler.base_lr = lr
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    # -- state ---------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def _keeps_master(self, weight):
        return self.multi_precision and weight.dtype in _LOW_PRECISION

    def create_state_multi_precision(self, index, weight):
        """``(fp32 master, create_state(master))`` for an fp16 / bf16 weight
        under ``multi_precision``, else ``create_state``."""
        if self._keeps_master(weight):
            master = weight.detach().to(torch.float32,
                                        memory_format=torch.contiguous_format)
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    # -- update --------------------------------------------------------------
    def _prep_grad(self, g):
        """``g * rescale_grad``, clipped elementwise where ``clip_gradient``
        is above 0: a new tensor."""
        g = g * self.rescale_grad
        c = self.clip_gradient
        if c is not None and c == c and c > 0:
            g.clamp_(-c, c)
        return g

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        """Update ``weight`` (and ``state``) in place from ``grad``."""
        self._update_count(index)
        self._update_impl(index, weight, grad, state, self._get_lr(index),
                          self._get_wd(index))

    @torch.no_grad()
    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update` on the fp32 master of an fp16 / bf16 weight under
        ``multi_precision`` (the gradient widened to fp32), then the master
        rounded into the weight; else :meth:`update`."""
        if not self._keeps_master(weight):
            self.update(index, weight, grad, state)
            return
        master, inner = state
        self._update_count(index)
        self._update_impl(index, master, grad.to(torch.float32), inner,
                          self._get_lr(index), self._get_wd(index))
        weight.copy_(master)

    def _update_impl(self, index, w, g, state, lr, wd):
        raise NotImplementedError

    def _prep_grads(self, gs):
        """:meth:`_prep_grad` over a list: new tensors."""
        gs = torch._foreach_mul(gs, self.rescale_grad)
        c = self.clip_gradient
        if c is not None and c == c and c > 0:
            torch._foreach_clamp_min_(gs, -c)
            torch._foreach_clamp_max_(gs, c)
        return gs

    def _update_multi(self, ws, gs, states, lr, wd, t):
        """The rule over lists (one device and dtype, the same ``lr``,
        ``wd`` and update count ``t``), in place on ``ws`` and
        ``states``."""
        raise NotImplementedError

    def __getstate__(self):
        # live Parameters are not serialized (reference: get_states)
        state = dict(self.__dict__)
        state["param_dict"] = {}
        return state


_LOW_PRECISION = (torch.float16, torch.bfloat16)


def _zeros_like(weight):
    return torch.zeros_like(weight, memory_format=torch.contiguous_format)


@register
class SGD(Optimizer):
    """Reference: optimizer/sgd.py (sgd_update / sgd_mom_update):
    ``g = clip(g * rescale) + wd * w``; ``mom = momentum * mom - lr * g``;
    ``w += mom`` (``w -= lr * g`` without momentum). State: the momentum
    buffer."""

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    _FUSED_FAMILY = "sgd"

    def _update_impl(self, index, w, g, mom, lr, wd):
        g = self._prep_grad(g).add_(w, alpha=wd)
        if mom is None:
            w.add_(g, alpha=-lr)
            return
        mom.mul_(self.momentum).add_(g, alpha=-lr)
        w.add_(mom)

    def _update_multi(self, ws, gs, moms, lr, wd, t):
        gs = self._prep_grads(gs)
        torch._foreach_add_(gs, ws, alpha=wd)
        if moms[0] is None:
            torch._foreach_add_(ws, gs, alpha=-lr)
            return
        torch._foreach_mul_(moms, self.momentum)
        torch._foreach_add_(moms, gs, alpha=-lr)
        torch._foreach_add_(ws, moms)


@register
class Adam(Optimizer):
    """Reference: optimizer/adam.py (adam_update). State: (mean, var)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    _FUSED_FAMILY = "adam"

    def _moments(self, g, state):
        m, v = state
        m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
        v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
        return m, v

    def _moments_multi(self, gs, states):
        ms = [s[0] for s in states]
        vs = [s[1] for s in states]
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, gs, alpha=1 - self.beta1)
        torch._foreach_mul_(vs, self.beta2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - self.beta2)
        return ms, vs

    def _t(self, index):
        # the parameter's own count after update(); the step's num_update
        # when a functional step calls _update_impl directly
        # (parallel.ShardedTrainStep), as the reference's Adam reads it
        t = self._index_update_count.get(index, self.num_update)
        return float(max(t, 1))

    def _update_impl(self, index, w, g, state, lr, wd):
        g = self._prep_grad(g).add_(w, alpha=wd)
        m, v = self._moments(g, state)
        t = self._t(index)
        lr_t = lr * math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        w.addcdiv_(m, v.sqrt().add_(self.epsilon), value=-lr_t)

    def _update_multi(self, ws, gs, states, lr, wd, t):
        gs = self._prep_grads(gs)
        torch._foreach_add_(gs, ws, alpha=wd)
        ms, vs = self._moments_multi(gs, states)
        lr_t = lr * math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        denom = torch._foreach_sqrt(vs)
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_addcdiv_(ws, ms, denom, value=-lr_t)


@register
class AdamW(Adam):
    """Decoupled weight decay (reference: optimizer/adamw.py):
    ``w -= lr * (mhat / (sqrt(vhat) + eps) + wd * w)``."""

    def _update_impl(self, index, w, g, state, lr, wd):
        m, v = self._moments(self._prep_grad(g), state)
        t = self._t(index)
        denom = (v / (1 - self.beta2 ** t)).sqrt_().add_(self.epsilon)
        upd = (m / (1 - self.beta1 ** t)).div_(denom).add_(w, alpha=wd)
        w.add_(upd, alpha=-lr)

    def _update_multi(self, ws, gs, states, lr, wd, t):
        ms, vs = self._moments_multi(self._prep_grads(gs), states)
        denom = torch._foreach_div(vs, 1 - self.beta2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.epsilon)
        upd = torch._foreach_div(ms, 1 - self.beta1 ** t)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, ws, alpha=wd)
        torch._foreach_add_(ws, upd, alpha=-lr)


def _map_state(fn, state):
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(_map_state(fn, s) for s in state)
    return fn(state)


def _state_tensor(a, dtype, device):
    """A copy of the state array ``a`` as a tensor of ``dtype`` on
    ``device`` (``a``'s dtype on the CPU where they are None)."""
    like = {} if dtype is None else dict(dtype=dtype, device=device)
    return torch.tensor(onp.asarray(a), **like)


def _to_numpy(t):
    """A state tensor as a numpy array; bf16, which numpy lacks, widened to
    fp32 (exactly: loading casts it back to the weight's dtype)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class Updater:
    """Per-index optimizer states (reference: optimizer/updater.py)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):
        """The states (numpy) as pickled bytes; with ``dump_optimizer``
        the optimizer (hyperparameters, update counts) too."""
        serial = {k: _map_state(_to_numpy, s)
                  for k, s in self.states.items()}
        if dump_optimizer:
            return pickle.dumps((serial, copy.copy(self.optimizer)))
        return pickle.dumps(serial)

    def set_states(self, states, weights=None):
        """Restore ``get_states`` bytes (this program's own output: they
        are unpickled); ``weights`` as in :meth:`set_state_arrays`."""
        data = pickle.loads(states)
        if isinstance(data, tuple):
            data, self.optimizer = data
        self.set_state_arrays(data, weights)

    def set_state_arrays(self, states, weights=None):
        """Take ``states`` {index: None, array or tuple of arrays} as
        tensors, once: each on the device and in the dtype of
        ``weights[index]`` ({index: weight tensor}), in fp32 where the
        optimizer keeps an fp32 master of that weight (``multi_precision``),
        or on the CPU where no weight is given."""
        weights = weights or {}

        def like(w):
            if w is None:
                return None, None
            keep = self.optimizer._keeps_master(w)
            return (torch.float32 if keep else w.dtype), w.device

        self.states = {
            i: _map_state(lambda a, dd=like(weights.get(i)):
                          _state_tensor(a, *dd), s)
            for i, s in states.items()}


def get_updater(optimizer):
    return Updater(optimizer)
