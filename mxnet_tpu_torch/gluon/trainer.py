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
NAG, Adam, AdamW, Adamax, AdaBelief, Nadam; ``multi_precision`` off) they
are updated together
(:class:`_FusedUpdate`, ``torch._foreach_*`` ops over every parameter of
one device and dtype); otherwise one ``Updater`` call each.

The kvstore (reference: trainer.py ``_init_kvstore``, made at the first
step): ``None`` / ``""`` is none; "device", "local" or "nccl" (or a
``kvstore.KVStore`` object) is the one-card store, through which
gradients pass only where they change: with ``compression_params``
(``{"type": "2bit", "threshold": t}``) each gradient is pushed and pulled
back quantized with its residual, as the reference's store does on one
worker; with ``update_on_kvstore=True`` the optimizer runs inside the
store (each gradient pushed, each weight pulled back), which gives the
weights of the local update. Otherwise one card has nothing to reduce and
the gradients stay as they are.

Row-sparse gradients (a ``grad_stype="row_sparse"`` parameter:
``Embedding(sparse_grad=True)``) force ``update_on_kvstore`` when it is
left None, and ``update_on_kvstore=False`` with a store raises
(reference: trainer.py:171-186). On the one-card store without
compression the forced mode binds each row-sparse weight as its key's
value (``KVStore._bind``): the push runs the optimizer's lazy rule on the
weight's touched rows in place and nothing is pulled, while the dense
parameters stay in the fused update (the same ``Updater`` states, so the
same values as the reference's per-key store updates). Without a store a
row-sparse gradient takes one rule call (lazy or densified), as the
reference's ``_update`` does.

A distributed store ("dist_sync", "dist_device_sync", "dist_async",
"horovod", "byteps", or a ``DistKVStore`` object) reduces every gradient
across the processes before the update (a pushpull each, summed, then
rescaled by ``1 / batch_size``: pass the global batch); with
``update_on_kvstore`` the push reduces and the store's updater runs on
every rank, so the weights stay equal bit for bit across ranks. The
collectives run in ``step``, outside any captured graph. On more than
one process such a Trainer also marks its parameters, so the BatchNorm
layers they belong to train on the global batch's statistics (summed
over the processes in their forward, ``parallel.collectives.
sync_batch_stats``), as the reference's one program over a dp mesh
computes them.

The guard runs when an AMP loss scaler is attached (``amp.scale_loss``) or
the ``trainer.skip_nonfinite`` knob is set: a step whose gradients hold an
inf or NaN (one reduction over every gradient, one host read) leaves the
weights as they are, counts itself in ``nonfinite_steps``, backs the loss
scale off and zeroes the "add" gradients; a clean step lets the scale grow
(``LossScaler.update_scale(False)``). A skipped step is also recorded as
the reference records it: ``fault.record("trainer.nonfinite_skip")``,
``trainer.nonfinite_total`` and, with the flight recorder armed, a
blackbox ``nonfinite`` bundle.

With telemetry on, ``step`` is wrapped as in the reference
(trainer.py:255-360): ``trainer.steps_total``, ``trainer.step_seconds``
and the global gradient norm, one fp32 device scalar a step pushed into a
``pipeline.DeferredWindow`` (no host read on the step; fetched when the
window overflows or at ``drain_telemetry()``, which also refreshes the
``memory.*`` gauges, inside a ``train.drain`` span while tracing). The
finite check is a host sync and reports to ``pipeline.sync_guard``.
"""
from __future__ import annotations

import math
import os
import time

import torch

from .. import blackbox as _blackbox
from .. import config
from .. import fault as _fault
from .. import optimizer as opt
from .. import pipeline as _pipeline
from .. import telemetry as _telemetry
from .. import trace as _trace
from ..amp.loss_scaler import LossScaler, all_finite
from ..base import MXNetError
from ..kvstore import KVStoreBase
from ..kvstore import create as _create_kvstore
from ..kvstore.base import is_distributed
from ..kvstore.kvstore import KVStore as _LocalKVStore
from .parameter import Parameter

__all__ = ["Trainer"]


def _dense_values(grad):
    """A gradient's tensor of values (a row-sparse gradient's rows)."""
    return grad if isinstance(grad, torch.Tensor) else grad.data._data


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
        if not (kvstore is None or isinstance(kvstore, (str, KVStoreBase))):
            raise MXNetError(f"kvstore must be a name or a KVStore, got "
                             f"{type(kvstore).__name__}")
        from ..kvstore.dist import DistKVStore
        self._distributed = (is_distributed(kvstore)
                             or isinstance(kvstore, DistKVStore))
        if self._distributed:
            from .._dist_init import ensure_distributed, world_size
            ensure_distributed()
            if world_size() > 1:
                for p in params:
                    p._sync_batch_stats = True
        self._params = params
        self._kvstore_type = kvstore
        self._compression_params = compression_params
        #: None until the store decides (reference: trainer.py
        #: ``_init_kvstore``): row-sparse gradients force it on
        self._update_on_kvstore = update_on_kvstore
        #: the indices the store updates (every parameter's, with
        #: ``update_on_kvstore``; only the row-sparse ones' where they
        #: forced it on a one-card store)
        self._store_keys = ()
        #: the store, made at the first step (None: no kvstore)
        self._kvstore = None
        self._kv_initialized = False
        self._init_optimizer(optimizer, optimizer_params or {})
        self._scale = self._optimizer.rescale_grad
        self.nonfinite_steps = 0
        #: the AMP loss scaler, attached by ``amp.scale_loss``
        self._amp_loss_scaler = None
        #: deferred grad norms (telemetry on), created at the first step
        self._norm_window = None

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

    def _init_kvstore(self):
        """Make the store (reference: trainer.py ``_init_kvstore``): with
        ``update_on_kvstore`` the optimizer moves into it, and so does the
        updater whose states ``save_states`` and ``state_dict`` keep."""
        if self._kv_initialized:
            return
        kind = self._kvstore_type
        sparse = [i for i, p in enumerate(self._params)
                  if p.grad_stype == "row_sparse"]
        if kind is None or kind == "":
            self._update_on_kvstore = False
        else:
            kv = kind if isinstance(kind, KVStoreBase) \
                else _create_kvstore(kind)
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            forced = self._update_on_kvstore is None and bool(sparse)
            if self._update_on_kvstore is None:
                self._update_on_kvstore = forced
            elif sparse and not self._update_on_kvstore:
                raise MXNetError(
                    "update_on_kvstore=False is not supported with "
                    "row_sparse gradients (reference trainer.py raises too)")
            if sparse and self._distributed:
                raise MXNetError(
                    "row_sparse gradients over a distributed store are not "
                    "ported; use Embedding(sparse_grad=False)")
            if self._update_on_kvstore:
                kv.set_optimizer(self._optimizer)
                self._updater = kv._updater
                self._store_keys = range(len(self._params))
                if forced and isinstance(kv, _LocalKVStore) \
                        and not self._compression_params:
                    # one card: the store updates the row-sparse weights
                    # in place (lazily), the dense ones stay fused here
                    self._store_keys = sparse
                    for i in sparse:
                        kv._bind(i, self._params[i].data())
                else:
                    self._fused_update = False
            if self._distributed:
                # every key starts from the weights, as the reference's
                # _init_kvstore does (a dist_async pull reconciles them)
                for i, p in enumerate(self._params):
                    kv.init(i, p.data())
            self._kvstore = kv
        self._kv_initialized = True

    def allreduce_grads(self):
        """Reduce gradients across devices (reference: trainer.py
        ``allreduce_grads``). A distributed store sums every gradient
        over the processes; on one card the gradients pass through the
        store only where it changes them (compression) or keeps them
        (``update_on_kvstore``: pushed, the optimizer runs in the
        store)."""
        self._init_kvstore()
        kv = self._kvstore
        if kv is None or not (self._update_on_kvstore or self._distributed
                              or self._compression_params):
            return
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            if self._update_on_kvstore:
                if i in self._store_keys:
                    kv.init(i, p.data())
                    kv.push(i, p.grad(), priority=-i)
            else:
                kv.pushpull(i, p.grad(), out=p.grad(), priority=-i)

    # -- the non-finite guard -------------------------------------------------
    def _guard_active(self):
        return (self._amp_loss_scaler is not None
                or bool(config.get("trainer.skip_nonfinite")))

    def _grads_finite(self):
        """Whether every gradient is finite: one reduction over all of
        them, one host read."""
        if _pipeline._guard_depth:
            _pipeline.note_host_sync("trainer.finite_check")
        return all_finite(_dense_values(p.grad()) for p in self._params
                          if p.grad_req != "null")

    # -- telemetry: the deferred grad norm --------------------------------------
    def _grad_norm_device(self):
        """Global gradient L2 norm as one fp32 device scalar, not read
        here (``_note_grad_norm`` defers the read)."""
        grads = [_dense_values(p.grad()) for p in self._params
                 if p.grad_req != "null" and p.grad() is not None]
        if not grads:
            return None
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        return torch.linalg.vector_norm(torch.stack(norms))

    @staticmethod
    def _observe_grad_norm(norm):
        if math.isfinite(norm):
            _telemetry.observe("trainer.grad_norm", norm)

    def _note_grad_norm(self):
        """Record the step's grad norm without a sync: the device scalar
        goes into a bounded DeferredWindow, read when it overflows or at
        ``drain_telemetry()``."""
        dev = self._grad_norm_device()
        if dev is None:
            return
        if self._norm_window is None:
            self._norm_window = _pipeline.DeferredWindow()
        self._norm_window.push(dev, self._observe_grad_norm)

    def drain_telemetry(self):
        """Read every deferred grad norm into the ``trainer.grad_norm``
        histogram and refresh the ``memory.*`` gauges (reference:
        trainer.py ``drain_telemetry``): call at epoch boundaries or
        before ``telemetry.snapshot()``."""
        pending = len(self._norm_window) if self._norm_window is not None \
            else 0
        with _trace.span("train.drain", category="train", pending=pending):
            if self._norm_window is not None:
                self._norm_window.drain()
            if _telemetry._active:
                _telemetry.record_memory()

    def _skip_step(self):
        """Absorb a non-finite step: the weights stay, the count grows, the
        loss scale backs off, and "add" gradients are cleared so the poison
        does not reach the next step; the skip is recorded in the fault
        plane, telemetry and (armed) a blackbox bundle."""
        self.nonfinite_steps += 1
        _fault.record("trainer.nonfinite_skip")
        if _telemetry._active:
            _telemetry.inc("trainer.nonfinite_total")
        if _blackbox._active:
            # non-finite escalation is a terminal-class anomaly: freeze
            # the evidence window while the poisoned state is still live
            _blackbox.dump(trigger="nonfinite",
                           reason=f"non-finite gradients skipped "
                                  f"(count={self.nonfinite_steps})")
        if self._amp_loss_scaler is not None:
            self._amp_loss_scaler.update_scale(True)
        for p in self._params:
            if p.grad_req == "add":
                p.zero_grad()

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce, then update with gradients rescaled by
        ``1 / batch_size`` (reference: trainer.py ``step``); with the guard
        active, a step with an inf or NaN gradient is skipped. With
        telemetry on: wall time, step count and the deferred grad norm
        (observed before the update, so a skipped step still reports what
        blew up)."""
        if not _telemetry._active:
            return self._step_impl(batch_size)
        t0 = time.perf_counter()
        self._note_grad_norm()
        try:
            return self._step_impl(batch_size)
        finally:
            _telemetry.inc("trainer.steps_total")
            _telemetry.observe("trainer.step_seconds",
                               time.perf_counter() - t0)

    def _step_impl(self, batch_size):
        self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        guard = self._guard_active()
        # with the optimizer in the store the push updates: check first
        if guard and self._update_on_kvstore and not self._grads_finite():
            self._skip_step()
            return
        self.allreduce_grads()
        if guard:
            if not self._update_on_kvstore and not self._grads_finite():
                self._skip_step()
                return
            if self._amp_loss_scaler is not None:
                self._amp_loss_scaler.update_scale(False)
        self._update()

    def update(self, batch_size, ignore_stale_grad=False):
        """Update without reducing (reference: trainer.py ``update``); not
        with ``update_on_kvstore``, where the push is the update."""
        self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError("update() is not supported when parameters "
                             "are updated on the kvstore; call step()")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    def _update(self):
        work = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        if self._update_on_kvstore:
            # the store updated its copies at the push: pull them back (a
            # bound weight is the store's value: nothing to pull)
            for i, p in work:
                if i in self._store_keys:
                    self._kvstore.pull(i, out=p.data(), priority=-i)
            work = [(i, p) for i, p in work if i not in self._store_keys]
        # row-sparse gradients: one rule call each (lazy or densified)
        for i, p in work:
            if not isinstance(p.grad(), torch.Tensor):
                self._updater(i, p.grad(), p.data())
        work = [(i, p) for i, p in work if isinstance(p.grad(), torch.Tensor)]
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
        self._init_kvstore()
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
        self._init_kvstore()
        self._updater.set_states(blob, self._weights())
        self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._fused_update = None  # rebuilt against the restored optimizer

    def load_states_by_name(self, states, counts):
        """Start from another trainer's state by parameter name, for
        example the JAX package's converted to numpy: ``states`` {name:
        None, array or tuple of arrays}, ``counts`` {name: update count}.
        Names this trainer does not hold raise."""
        self._init_kvstore()
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
        self._init_kvstore()
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
