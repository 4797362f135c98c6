"""gluon.Trainer (one card).

Counterpart of ``mxnet_tpu/gluon/trainer.py``: ``Trainer(params,
optimizer, optimizer_params, kvstore=...)`` with ``step``, ``update``,
``allreduce_grads``, ``learning_rate``/``set_learning_rate`` and
``save_states``/``load_states``, and the non-finite guard with
``state_dict``/``load_state_dict`` (reference: trainer.py:225-245,
311-370, 421-440).

``step(batch_size)`` sets the optimizer's ``rescale_grad`` to
``1 / batch_size`` (times the initial rescale) and updates every parameter
whose ``grad_req`` is not "null", in place. Where the reference's
``_FusedUpdate.applicable()`` holds (the "sgd" and "adam" families: SGD,
Adam, AdamW; ``multi_precision`` off) they are updated together
(:class:`_FusedUpdate`, ``torch._foreach_*`` ops over every parameter of
one device and dtype); otherwise one ``Updater`` call each.
This slice runs on one card: kvstore ``None``, ``"device"`` or ``"local"``
reduces nothing, and a distributed kvstore, ``update_on_kvstore=True`` or
gradient compression raise.

The guard runs when an AMP loss scaler is attached (``amp.scale_loss``) or
the ``trainer.skip_nonfinite`` knob is set: a step whose gradients hold an
inf or NaN (one reduction over every gradient, one host read) leaves the
weights as they are, counts itself in ``nonfinite_steps``, backs the loss
scale off and zeroes the "add" gradients; a clean step lets the scale grow
(``LossScaler.update_scale(False)``). The reference's telemetry, fault and
blackbox hooks are host planes that the port does not have.
"""
from __future__ import annotations

import os

import torch

from .. import config
from .. import optimizer as opt
from ..amp.loss_scaler import LossScaler, all_finite
from ..base import MXNetError
from .parameter import Parameter

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "", "device", "local")


class _FusedUpdate:
    """Every parameter's update as a few multi-tensor ops (reference:
    trainer.py ``_FusedUpdate``, one jitted XLA program; the reference's
    own analog is ``multi_sgd_update`` / ``multi_lamb``).

    The optimizer's bookkeeping runs per parameter in the per-parameter
    order (``_update_count``, then ``_get_lr`` / ``_get_wd`` and Adam's
    ``t``), so an lr schedule, ``lr_mult`` and ``wd_mult`` act as they do
    one parameter at a time. The parameters are then grouped by (device,
    dtype, lr, wd, t), and each group goes through the optimizer's
    ``_update_multi``: the per-parameter rule's ops in its order as
    ``torch._foreach_*`` calls, one call per op and group. Most steps have
    one group a device and dtype. Not a CUDA graph: ``autograd.backward``
    gives every "write" leaf a fresh ``.grad`` each step, so the gradients'
    addresses move."""

    def __init__(self, optimizer):
        self.opt = optimizer

    def applicable(self):
        o = self.opt
        return (getattr(o, "_FUSED_FAMILY", None) in ("sgd", "adam")
                and not o.multi_precision)

    @torch.no_grad()
    def __call__(self, work, states):
        """work: list of (index, Parameter); states: ``Updater.states``."""
        o = self.opt
        adam = o._FUSED_FAMILY == "adam"
        groups = {}
        for i, p in work:
            o._update_count(i)
            w = p.data()
            key = (w.device, w.dtype, o._get_lr(i), o._get_wd(i),
                   o._t(i) if adam else None)
            ws, gs, ss = groups.setdefault(key, ([], [], []))
            ws.append(w)
            gs.append(p.grad())
            ss.append(states[i])
        for (_, _, lr, wd, t), (ws, gs, ss) in groups.items():
            o._update_multi(ws, gs, ss, lr, wd, t)


class Trainer:
    """Applies an optimizer to a set of parameters (reference: trainer.py
    ``Trainer``)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            self._param_names = list(params.keys())
            params = list(params.values())
        else:
            params = list(params)
            self._param_names = [p.name for p in params]
        if not params:
            raise MXNetError("no parameters to optimize")
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"expected Parameter, got {type(p)}")
        if not (kvstore is None or isinstance(kvstore, str)) \
                or kvstore not in _LOCAL_KVSTORES:
            raise MXNetError(f"kvstore {kvstore!r}: distributed kvstores are "
                             "not part of this slice of the port (one card: "
                             "None, 'device' or 'local')")
        if update_on_kvstore:
            raise MXNetError("update_on_kvstore=True is not part of this "
                             "slice of the port")
        if compression_params:
            raise MXNetError("gradient compression is not part of this "
                             "slice of the port")
        self._params = params
        self._kvstore = kvstore
        self._init_optimizer(optimizer, optimizer_params or {})
        self._scale = self._optimizer.rescale_grad
        self.nonfinite_steps = 0
        #: the AMP loss scaler, attached by ``amp.scale_loss``
        self._amp_loss_scaler = None

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)
        #: the reference's cached ``_FusedUpdate``: None until the first
        #: update decides, False where it does not apply
        self._fused_update = None

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _weights(self):
        return {i: p.data() for i, p in enumerate(self._params)}

    def allreduce_grads(self):
        """Reduce gradients across devices: nothing to reduce on one
        card."""

    # -- the non-finite guard -------------------------------------------------
    def _guard_active(self):
        return (self._amp_loss_scaler is not None
                or bool(config.get("trainer.skip_nonfinite")))

    def _grads_finite(self):
        """Whether every gradient is finite: one reduction over all of
        them, one host read."""
        return all_finite(p.grad() for p in self._params
                          if p.grad_req != "null")

    def _skip_step(self):
        """Absorb a non-finite step: the weights stay, the count grows, the
        loss scale backs off, and "add" gradients are cleared so the poison
        does not reach the next step."""
        self.nonfinite_steps += 1
        if self._amp_loss_scaler is not None:
            self._amp_loss_scaler.update_scale(True)
        for p in self._params:
            if p.grad_req == "add":
                p.zero_grad()

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce, then update with gradients rescaled by
        ``1 / batch_size`` (reference: trainer.py ``step``); with the guard
        active, a step with an inf or NaN gradient is skipped."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        if self._guard_active():
            if not self._grads_finite():
                self._skip_step()
                return
            if self._amp_loss_scaler is not None:
                self._amp_loss_scaler.update_scale(False)
        self._update()

    def update(self, batch_size, ignore_stale_grad=False):
        """Update without reducing (reference: trainer.py ``update``)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    def _update(self):
        work = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        if not work:
            return
        if self._fused_update is None:
            fu = _FusedUpdate(self._optimizer)
            self._fused_update = fu if fu.applicable() else False
        if not self._fused_update:
            for i, p in work:
                self._updater(i, p.grad(), p.data())
            return
        states = self._updater.states
        for i, p in work:
            if i not in states:
                states[i] = self._optimizer.create_state_multi_precision(
                    i, p.data())
        self._fused_update(work, states)

    # -- resume: what save_states misses (the loss scale and its window,
    # the skip count) beside the optimizer and its states as bytes ---------
    def state_dict(self):
        scaler = self._amp_loss_scaler
        return {"optimizer": self._updater.get_states(dump_optimizer=True),
                "nonfinite_steps": self.nonfinite_steps,
                "loss_scaler": None if scaler is None
                else scaler.state_dict()}

    def load_state_dict(self, state):
        self.nonfinite_steps = int(state.get("nonfinite_steps", 0))
        scaler_state = state.get("loss_scaler")
        if scaler_state is not None:
            if self._amp_loss_scaler is None:
                self._amp_loss_scaler = LossScaler()
            self._amp_loss_scaler.load_state_dict(scaler_state)
        if state.get("optimizer") is not None:
            self._restore_states(state["optimizer"])

    def _restore_states(self, blob):
        """The optimizer and its states from ``Updater.get_states`` bytes,
        each state on its weight's device."""
        self._updater.set_states(blob, self._weights())
        self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._fused_update = None  # rebuilt against the restored optimizer

    def load_states_by_name(self, states, counts):
        """Start from another trainer's state by parameter name, for
        example the JAX package's converted to numpy: ``states`` {name:
        None, array or tuple of arrays}, ``counts`` {name: update count}.
        Names this trainer does not hold raise."""
        index = {n: i for i, n in enumerate(self._param_names)}
        unknown = sorted((set(states) | set(counts)) - set(index))
        if unknown:
            raise MXNetError(f"load_states_by_name: unknown parameters "
                             f"{unknown[:4]}")
        self._updater.set_state_arrays(
            {index[n]: s for n, s in states.items()}, self._weights())
        o = self._optimizer
        o._index_update_count = {index[n]: int(c) for n, c in counts.items()}
        o.num_update = max([o.begin_num_update, *counts.values()])

    def save_states(self, fname):
        """Write the optimizer and its states to ``fname`` (temporary file
        and rename, so a crash leaves the old file)."""
        tmp = f"{fname}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=True))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fname)

    def load_states(self, fname):
        """Restore what ``save_states`` wrote."""
        with open(fname, "rb") as f:
            self._restore_states(f.read())
