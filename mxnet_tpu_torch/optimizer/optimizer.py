"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py``: the ``Optimizer``
base (rescale_grad, clip_gradient, wd, lr_scheduler, per-index update
counts, lr_mult / wd_mult), the reference's optimizers (``Test``, ``SGD``,
``NAG``, ``Signum``, ``SGLD``, ``Adam``, ``AdamW``, ``Adamax``, ``FTML``,
``AdaBelief``, ``Nadam``, ``AdaGrad``, ``AdaDelta``, ``RMSProp``,
``Ftrl``, ``LAMB``, ``LANS``, ``LARS``, ``DCASGD``; ``GroupAdaGrad`` in
``contrib.py``), the registry (``register``/``create``) and
``Updater``/``get_updater``.

The update rules are the reference's arithmetic in its order (not
``torch.optim``'s), for example:

- ``Adam`` adds ``wd * w`` into the gradient and applies
  ``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` to ``m / (sqrt(v) + eps)``
  (eps not bias-corrected);
- ``AdamW`` decouples the decay: ``w -= lr * (mhat / (sqrt(vhat) + eps)
  + wd * w)``;
- ``LAMB`` takes ``t`` from the optimizer's ``num_update`` and its trust
  ratio ``||w|| / ||r||`` as a device scalar (no host read);
- ``clip_gradient`` clips elementwise after rescaling, only where it is a
  number above 0 (None, 0, a negative value and NaN mean no clipping, as
  the reference's ``clip == clip and clip > 0`` over ``clip_gradient or
  -1.0``);
- ``t`` is the parameter's own count after ``update`` (the optimizer's
  ``num_update`` for a functional step that calls ``_update_impl``).

They run as plain PyTorch in place on the weight and state tensors (the
reference runs them as one XLA program per step; no Pallas kernel is
involved). The members of the reference's fused families (``_FUSED_FAMILY``
"sgd": SGD, NAG; "adam": Adam, AdamW, Adamax, AdaBelief, Nadam) carry
their rule over lists of tensors (``_update_multi``), as ``torch._foreach_*``
calls that ``gluon.Trainer``'s ``_FusedUpdate`` runs for many parameters at
once; each has its own, so a subclass never runs its parent's rule (the
reference's ``_FusedUpdate`` takes ``type(opt)._rule``). NAG, Adamax,
AdaBelief and Nadam write the rule once, over lists, and run one
parameter as a list of one (``_update_one``). A ``RowSparseNDArray``
gradient (``Embedding(sparse_grad=True)``) is densified, or, where
``lazy_update`` is on, updates only its rows of the weight and the state
(``_lazy_update_impl``: SGD with and without momentum, Adam, and
``GroupAdaGrad``; the subclasses inherit their parent's, as in the
reference, Adamax refusing; every other optimizer raises);
``lazy_update=`` does nothing on dense gradients, as in the reference;
``SGLD`` draws its noise from its ``generator`` (a ``torch.Generator``)
or the default generator of the weight's device.

``multi_precision=True`` (reference: optimizer.py:136-141, 177-195) keeps
an fp32 master copy of every fp16 or bf16 weight: the state is the tuple
``(master, inner)``, ``inner`` the rule's own state made from the master
(fp32), the rule runs on the master with the gradient widened to fp32, and
the weight receives the master rounded to its dtype. ``Updater`` calls
``create_state_multi_precision`` and ``update_multi_precision``; its state
arrays keep the master and its state in fp32 when they are saved and
loaded, and it loads the JAX package's pickled ``(states, optimizer)``
too.
"""
from __future__ import annotations

import copy
import io
import math
import pickle

import numpy as onp
import torch

from ..base import MXNetError
from ..ndarray.sparse import RowSparseNDArray, _rows_of, _set_rows

__all__ = ["Optimizer", "Test", "SGD", "NAG", "Signum", "SGLD", "Adam",
           "AdamW", "Adamax", "FTML", "AdaBelief", "Nadam", "AdaGrad",
           "AdaDelta", "RMSProp", "Ftrl", "LAMB", "LANS", "LARS", "DCASGD",
           "Updater", "register", "create", "get_updater"]

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
        """Update ``weight`` (and ``state``) in place from ``grad``. A
        ``RowSparseNDArray`` gradient updates only its rows where
        ``lazy_update`` is on (:meth:`_lazy_update_impl`), and is
        densified otherwise (reference: optimizer.py:157-170)."""
        self._update_count(index)
        self._apply(index, weight, grad, state, self._get_lr(index),
                    self._get_wd(index))

    def _apply(self, index, w, grad, state, lr, wd):
        if isinstance(grad, RowSparseNDArray):
            if self.lazy_update:
                self._lazy_update_impl(index, w, grad, state, lr, wd)
                return
            grad = grad.tostype("default")._data
        self._update_impl(index, w, grad, state, lr, wd)

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
        grad = grad.astype(torch.float32) \
            if isinstance(grad, RowSparseNDArray) else grad.to(torch.float32)
        self._apply(index, master, grad, inner, self._get_lr(index),
                    self._get_wd(index))
        weight.copy_(master)

    def _update_impl(self, index, w, g, state, lr, wd):
        raise NotImplementedError

    #: whether a row-sparse gradient updates only its rows (the
    #: optimizers that have a lazy rule take ``lazy_update=``)
    lazy_update = False

    def _lazy_update_impl(self, index, w, rsp, state, lr, wd):
        """The rule on ``rsp``'s rows of ``w`` and the state only (reading
        and writing those rows; sentinel slots write nothing)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no lazy sparse update; use "
            "lazy_update=False to densify row_sparse gradients")

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

    def _t(self, index):
        # the parameter's own count after update(); the step's num_update
        # when a functional step calls _update_impl directly
        # (parallel.ShardedTrainStep), as the reference's Adam reads it
        t = self._index_update_count.get(index, self.num_update)
        return float(max(t, 1))

    def _update_one(self, index, w, g, state, lr, wd):
        """The list rule (:meth:`_update_multi`) on one tensor: a family
        member written once over lists, so its fused and per-parameter
        paths run the same ops."""
        self._update_multi([w], [g], [state], lr, wd, self._t(index))

    def __getstate__(self):
        # live Parameters are not serialized (reference: get_states)
        state = dict(self.__dict__)
        state["param_dict"] = {}
        return state


_LOW_PRECISION = (torch.float16, torch.bfloat16)


def _prep_multi(o, gs, ws, wd):
    """``clip(g * rescale) + wd * w`` over lists: new tensors."""
    gs = o._prep_grads(gs)
    torch._foreach_add_(gs, ws, alpha=wd)
    return gs


def _zeros_like(weight):
    return torch.zeros_like(weight, memory_format=torch.contiguous_format)


@register
class SGD(Optimizer):
    """Reference: optimizer/sgd.py (sgd_update / sgd_mom_update):
    ``g = clip(g * rescale) + wd * w``; ``mom = momentum * mom - lr * g``;
    ``w += mom`` (``w -= lr * g`` without momentum). State: the momentum
    buffer."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=False,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

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

    def _lazy_update_impl(self, index, w, rsp, mom, lr, wd):
        """The rule on ``rsp``'s rows (reference: sgd.py lazy_update over
        optimizer_op.cc SGDUpdateRspImpl), in the dense rule's ops."""
        idx = rsp.indices._data
        w_rows = _rows_of(w, idx)
        g = self._prep_grad(rsp.data._data.to(w.dtype)).add_(w_rows,
                                                             alpha=wd)
        if mom is None:
            _set_rows(w, idx, w_rows.add_(g, alpha=-lr))
            return
        m_rows = _rows_of(mom, idx).mul_(self.momentum).add_(g, alpha=-lr)
        _set_rows(mom, idx, m_rows)
        _set_rows(w, idx, w_rows.add_(m_rows))

    def _update_multi(self, ws, gs, moms, lr, wd, t):
        gs = _prep_multi(self, gs, ws, wd)
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
                 epsilon=1e-8, lazy_update=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _lazy_update_impl(self, index, w, rsp, state, lr, wd):
        """The rule on ``rsp``'s rows (reference: adam.py lazy_update over
        AdamUpdateRspImpl): the m / v of the other rows stay."""
        m, v = state
        idx = rsp.indices._data
        w_rows = _rows_of(w, idx)
        g = self._prep_grad(rsp.data._data.to(w.dtype)).add_(w_rows,
                                                             alpha=wd)
        m_rows, v_rows = self._moments(g, (_rows_of(m, idx),
                                           _rows_of(v, idx)))
        t = self._t(index)
        lr_t = lr * math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        w_rows.addcdiv_(m_rows, v_rows.sqrt().add_(self.epsilon),
                        value=-lr_t)
        _set_rows(m, idx, m_rows)
        _set_rows(v, idx, v_rows)
        _set_rows(w, idx, w_rows)

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

    def _update_impl(self, index, w, g, state, lr, wd):
        g = self._prep_grad(g).add_(w, alpha=wd)
        m, v = self._moments(g, state)
        t = self._t(index)
        lr_t = lr * math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        w.addcdiv_(m, v.sqrt().add_(self.epsilon), value=-lr_t)

    def _update_multi(self, ws, gs, states, lr, wd, t):
        ms, vs = self._moments_multi(_prep_multi(self, gs, ws, wd), states)
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


@register
class Test(Optimizer):
    """Reference: optimizer.py ``Test`` (for the kvstore tests):
    ``w += g * rescale_grad``; the state holds the new weight."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def _update_impl(self, index, w, g, state, lr, wd):
        w.add_(g * self.rescale_grad)
        state.copy_(w)


@register
class NAG(SGD):
    """Nesterov momentum (reference: optimizer.py ``NAG``, "sgd" family):
    ``g = clip(g * rescale) + wd * w``; ``mom = momentum * mom + g``;
    ``w -= lr * (g + momentum * mom)`` (``w -= lr * g`` without
    momentum). Written over lists once; one parameter is a list of one."""

    _update_impl = Optimizer._update_one

    def _lazy_update_impl(self, index, w, rsp, mom, lr, wd):
        """The rule on ``rsp``'s rows (reference: sgd.py lazy_update over
        optimizer_op.cc SGDUpdateRspImpl), in the dense rule's ops."""
        idx = rsp.indices._data
        w_rows = _rows_of(w, idx)
        g = self._prep_grad(rsp.data._data.to(w.dtype)).add_(w_rows,
                                                             alpha=wd)
        if mom is None:
            _set_rows(w, idx, w_rows.add_(g, alpha=-lr))
            return
        m_rows = _rows_of(mom, idx).mul_(self.momentum).add_(g, alpha=-lr)
        _set_rows(mom, idx, m_rows)
        _set_rows(w, idx, w_rows.add_(m_rows))

    def _update_multi(self, ws, gs, moms, lr, wd, t):
        gs = _prep_multi(self, gs, ws, wd)
        if moms[0] is None:
            torch._foreach_add_(ws, gs, alpha=-lr)
            return
        torch._foreach_mul_(moms, self.momentum)
        torch._foreach_add_(moms, gs)
        torch._foreach_add_(gs, moms, alpha=self.momentum)
        torch._foreach_add_(ws, gs, alpha=-lr)


@register
class Signum(Optimizer):
    """Reference: optimizer.py ``Signum``: the sign of the momentum step,
    ``wd_lh`` the decoupled decay."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def _update_impl(self, index, w, g, mom, lr, wd):
        g = self._prep_grad(g)
        if mom is not None:
            mom.mul_(self.momentum).add_(g, alpha=-(1 - self.momentum))
            w.copy_(w * (1 - lr * self.wd_lh) + lr * torch.sign(mom)
                    - lr * wd * w)
            return
        w.copy_(w * (1 - lr * self.wd_lh)
                - lr * torch.sign(g.add_(w, alpha=wd)))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference: optimizer.py
    ``SGLD``): ``w -= lr / 2 * (clip(g * rescale) + wd * w)`` plus
    ``N(0, lr)`` noise drawn from ``generator`` (a ``torch.Generator``
    on the weight's device), else from the default generator of the
    weight's device; the JAX package's threefry stream cannot be matched,
    so tests give both the same noise."""

    _zero_partitionable = False  # fresh noise per full tensor

    def __init__(self, learning_rate=0.01, generator=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.generator = generator

    def _noise(self, w):
        from .. import random as _random
        gen = self.generator if self.generator is not None \
            else _random.default_generator(w.device)
        _random.note_draw(gen)
        return torch.randn(w.shape, dtype=w.dtype, device=w.device,
                           generator=gen)

    def _update_impl(self, index, w, g, state, lr, wd):
        g = self._prep_grad(g).add_(w, alpha=wd)
        noise = self._noise(w) * math.sqrt(lr)
        w.add_(g, alpha=-0.5 * lr).add_(noise)

    def __getstate__(self):
        state = super().__getstate__()
        state["generator"] = None  # a generator does not pickle
        return state


@register
class Adamax(Adam):
    """AdaMax (reference: optimizer.py ``Adamax``, "adam" family): Adam
    with the infinity norm, state ``(m, u)``: ``u = max(beta2 * u, |g|)``,
    ``w -= lr / (1 - beta1^t) * m / (u + eps)``. Written over lists
    once."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, beta1=beta1,
                         beta2=beta2, epsilon=epsilon, **kwargs)

    _update_impl = Optimizer._update_one

    def _lazy_update_impl(self, index, w, rsp, state, lr, wd):
        # Adam's row rule would misuse the infinity-norm state
        raise NotImplementedError(
            "Adamax has no lazy sparse update; use lazy_update=False")

    def _update_multi(self, ws, gs, states, lr, wd, t):
        gs = _prep_multi(self, gs, ws, wd)
        ms = [s[0] for s in states]
        us = [s[1] for s in states]
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, gs, alpha=1 - self.beta1)
        torch._foreach_mul_(us, self.beta2)
        torch._foreach_maximum_(us, torch._foreach_abs(gs))
        denom = torch._foreach_add(us, self.epsilon)
        torch._foreach_addcdiv_(ws, ms, denom,
                                value=-lr / (1 - self.beta1 ** t))


@register
class FTML(Optimizer):
    """Follow The Moving Leader (reference: optimizer.py ``FTML``); state
    ``(d, v, z)``, ``t`` the parameter's own count."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return tuple(_zeros_like(weight) for _ in range(3))

    def _update_impl(self, index, w, g, state, lr, wd):
        d, v, z = state
        b1, b2, t = self.beta1, self.beta2, self._t(index)
        g = self._prep_grad(g).add_(w, alpha=wd)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        d_t = (v / (1 - b2 ** t)).sqrt_().add_(self.epsilon) \
            .mul_((1 - b1 ** t) / lr)
        z.mul_(b1).add_(g, alpha=1 - b1).sub_((d_t - b1 * d) * w)
        d.copy_(d_t)
        w.copy_(-z / d_t)


@register
class AdaBelief(Adam):
    """Reference: optimizer.py ``AdaBelief`` ("adam" family): ``v`` tracks
    ``(g - m)^2 + eps``. Written over lists once."""

    _update_impl = Optimizer._update_one

    def _update_multi(self, ws, gs, states, lr, wd, t):
        gs = _prep_multi(self, gs, ws, wd)
        ms = [s[0] for s in states]
        vs = [s[1] for s in states]
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, gs, alpha=1 - self.beta1)
        dev = torch._foreach_sub(gs, ms)
        torch._foreach_mul_(vs, self.beta2)
        torch._foreach_addcmul_(vs, dev, dev, value=1 - self.beta2)
        torch._foreach_add_(vs, self.epsilon)
        lr_t = lr * math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        denom = torch._foreach_sqrt(vs)
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_addcdiv_(ws, ms, denom, value=-lr_t)


@register
class Nadam(Adam):
    """Reference: optimizer.py ``Nadam`` ("adam" family):
    ``w -= lr * (beta1 * mhat + (1 - beta1) * g / (1 - beta1^t)) /
    (sqrt(vhat) + eps)``. Written over lists once."""

    _update_impl = Optimizer._update_one

    def _update_multi(self, ws, gs, states, lr, wd, t):
        gs = _prep_multi(self, gs, ws, wd)
        b1, b2 = self.beta1, self.beta2
        ms, vs = self._moments_multi(gs, states)
        denom = torch._foreach_div(vs, 1 - b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.epsilon)
        m_bar = torch._foreach_mul(ms, b1 / (1 - b1 ** t))
        torch._foreach_add_(m_bar, gs, alpha=(1 - b1) / (1 - b1 ** t))
        torch._foreach_addcdiv_(ws, m_bar, denom, value=-lr)


@register
class AdaGrad(Optimizer):
    """Reference: optimizer.py ``AdaGrad``: ``hist += g^2``,
    ``w -= lr * g / (sqrt(hist) + eps)``."""

    def __init__(self, learning_rate=0.01, epsilon=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def _update_impl(self, index, w, g, hist, lr, wd):
        g = self._prep_grad(g).add_(w, alpha=wd)
        hist.addcmul_(g, g)
        w.addcdiv_(g, hist.sqrt().add_(self.epsilon), value=-lr)


@register
class AdaDelta(Optimizer):
    """Reference: optimizer.py ``AdaDelta``; state ``(acc_g, acc_delta)``."""

    def __init__(self, learning_rate=1.0, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _update_impl(self, index, w, g, state, lr, wd):
        acc_g, acc_d = state
        rho, eps = self.rho, self.epsilon
        g = self._prep_grad(g).add_(w, alpha=wd)
        acc_g.mul_(rho).addcmul_(g, g, value=1 - rho)
        delta = (acc_d + eps).sqrt_().div_((acc_g + eps).sqrt_()).mul_(g)
        acc_d.mul_(rho).addcmul_(delta, delta, value=1 - rho)
        w.add_(delta, alpha=-lr)


@register
class RMSProp(Optimizer):
    """Reference: optimizer.py ``RMSProp``, plain (state ``n``) and
    ``centered`` (Graves; state ``(n, mean g, delta)``), ``clip_weights``
    clamping the result."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.momentum = rho, momentum
        self.epsilon, self.centered = epsilon, centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return tuple(_zeros_like(weight) for _ in range(3))
        return _zeros_like(weight)

    def _update_impl(self, index, w, g, state, lr, wd):
        rho = self.rho
        g = self._prep_grad(g).add_(w, alpha=wd)
        if self.centered:
            n, mg, delta = state
            n.mul_(rho).addcmul_(g, g, value=1 - rho)
            mg.mul_(rho).add_(g, alpha=1 - rho)
            den = (n - mg * mg).add_(self.epsilon).sqrt_()
            delta.mul_(self.momentum).addcdiv_(g, den, value=-lr)
            w.add_(delta)
        else:
            state.mul_(rho).addcmul_(g, g, value=1 - rho)
            w.addcdiv_(g, state.sqrt().add_(self.epsilon), value=-lr)
        if self.clip_weights:
            w.clamp_(-self.clip_weights, self.clip_weights)


@register
class Ftrl(Optimizer):
    """Reference: optimizer.py ``Ftrl`` (FTRL-proximal); state ``(z, n)``."""

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _update_impl(self, index, w, g, state, lr, wd):
        z, n = state
        g = self._prep_grad(g)
        sigma = ((n + g * g).sqrt_() - n.sqrt()).div_(lr)
        z.add_(g).sub_(sigma * w)
        n.addcmul_(g, g)
        new = -(z - torch.sign(z) * self.lamda1) \
            / ((self.beta + n.sqrt()) / lr + wd)
        w.copy_(torch.where(z.abs() <= self.lamda1, torch.zeros_like(w),
                            new))


def _trust(num, den, ok):
    """``num / den`` where ``ok``, else 1 (device scalars, no host read)."""
    return torch.where(ok, num / den, torch.ones_like(num))


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments (reference: optimizer.py ``LAMB``):
    Adam moments (bias-corrected unless ``bias_correction=False``, ``t``
    the optimizer's ``num_update``), ``r = mhat / (sqrt(vhat) + eps) +
    wd * w``, the trust ratio ``||w|| / ||r||`` (1 where either norm is 0)
    clamped to ``[lower_bound, upper_bound]``, ``w -= lr * ratio * r``.
    The norms stay on the device: no host read."""

    _zero_partitionable = False  # layer-wise norms need the whole tensor

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _update_impl(self, index, w, g, state, lr, wd):
        m, v = state
        b1, b2, t = self.beta1, self.beta2, self.num_update
        g = self._prep_grad(g)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        if self.bias_correction:
            mhat, vhat = m / (1 - b1 ** t), v / (1 - b2 ** t)
        else:
            mhat, vhat = m.clone(), v
        r = mhat.div_(vhat.sqrt().add_(self.epsilon)).add_(w, alpha=wd)
        w_norm = torch.linalg.vector_norm(w)
        r_norm = torch.linalg.vector_norm(r)
        ratio = _trust(w_norm, r_norm, (w_norm > 0) & (r_norm > 0))
        if self.lower_bound is not None:
            ratio = ratio.clamp(min=self.lower_bound)
        if self.upper_bound is not None:
            ratio = ratio.clamp(max=self.upper_bound)
        w.sub_(r.mul_(ratio).mul_(lr))


@register
class LANS(LAMB):
    """Reference: optimizer.py ``LANS``: LAMB on the gradient divided by
    its norm (where the norm is above 0), before the rescale."""

    def _update_impl(self, index, w, g, state, lr, wd):
        g_norm = torch.linalg.vector_norm(g)
        g = torch.where(g_norm > 0, g / g_norm, g)
        super()._update_impl(index, w, g, state, lr, wd)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling (reference: optimizer.py ``LARS``):
    ``trust = eta * ||w|| / (||g|| + wd * ||w|| + eps)`` (1 where either
    norm is 0), ``mom = momentum * mom + lr * trust * (g + wd * w)``,
    ``w -= mom``."""

    _zero_partitionable = False  # trust ratio needs whole-tensor norms

    def __init__(self, learning_rate=0.1, momentum=0.0, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.eta, self.epsilon = momentum, eta, epsilon

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def _update_impl(self, index, w, g, mom, lr, wd):
        g = self._prep_grad(g)
        w_norm = torch.linalg.vector_norm(w)
        g_norm = torch.linalg.vector_norm(g)
        trust = _trust(self.eta * w_norm, g_norm + wd * w_norm
                       + self.epsilon, (w_norm > 0) & (g_norm > 0))
        g.add_(w, alpha=wd)
        step = g.mul_(trust).mul_(lr)
        if mom is None:
            w.sub_(step)
            return
        mom.mul_(self.momentum).add_(step)
        w.sub_(mom)


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (reference: optimizer.py ``DCASGD``);
    state ``(mom, previous weight)``."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.lamda = momentum, lamda

    def create_state(self, index, weight):
        return (_zeros_like(weight),
                weight.detach().clone(memory_format=torch.contiguous_format))

    def _update_impl(self, index, w, g, state, lr, wd):
        mom, prev = state
        g = self._prep_grad(g).add_(w, alpha=wd)
        comp = g + self.lamda * g * g * (w - prev)
        mom.mul_(self.momentum).add_(comp, alpha=-lr)
        w.add_(mom)
        prev.copy_(w)


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
        """Restore ``get_states`` bytes, this package's or the JAX
        package's (its ``(states, optimizer)`` tuple loads as this
        package's optimizer of the same name: :class:`_Unpickler`). They
        are unpickled, so they must come from a trusted file. ``weights``
        as in :meth:`set_state_arrays`."""
        data = _Unpickler(io.BytesIO(states)).load()
        if isinstance(data, tuple):
            data, opt = data
            # an optimizer pickled by the JAX package lacks this package's
            # own attributes (SGLD's generator): a default instance's
            for k, v in vars(type(opt)()).items():
                opt.__dict__.setdefault(k, v)
            opt.__dict__.pop("_master_weights", None)
            self.optimizer = opt
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


class _Unpickler(pickle.Unpickler):
    """Reads the JAX package's optimizer pickles: a class of
    ``mxnet_tpu.<module>`` (an optimizer, an lr scheduler) resolves to
    this package's class of the same module and name."""

    def find_class(self, module, name):
        if module == "mxnet_tpu" or module.startswith("mxnet_tpu."):
            module = "mxnet_tpu_torch" + module[len("mxnet_tpu"):]
        return super().find_class(module, name)


def get_updater(optimizer):
    return Updater(optimizer)
