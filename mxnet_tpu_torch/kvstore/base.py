"""KVStore base and plugin registry.

Counterpart of ``mxnet_tpu/kvstore/base.py``: ``KVStoreBase`` (the plugin
interface and ``register``), ``TestStore`` (the trivial in-memory
backend, registered as "teststore") and ``create``. "local", "device",
"nccl", "local_allreduce_device" and "local_allreduce_cpu" are the
single-process :class:`~.kvstore.KVStore`; "dist_sync" and
"dist_device_sync" the :class:`~.dist.DistKVStore`, "dist_async" the
:class:`~.dist.DistAsyncKVStore` (``kvstore/dist.py``), and "horovod" /
"byteps" the registered plugins of ``kvstore/horovod.py``.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["KVStoreBase", "TestStore", "create"]

_LOCAL = ("local", "device", "nccl", "local_allreduce_device",
          "local_allreduce_cpu")
_DISTRIBUTED = ("dist", "horovod", "byteps")


class KVStoreBase:
    """Plugin interface (reference: kvstore/base.py ``KVStoreBase``)."""

    kv_registry = {}
    OPTIMIZER = "optimizer"

    @staticmethod
    def register(klass):
        KVStoreBase.kv_registry[klass.__name__.lower()] = klass
        return klass

    def broadcast(self, key, value, out, priority=0):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        raise NotImplementedError

    @staticmethod
    def is_capable(capability):
        raise NotImplementedError

    @property
    def type(self):
        raise NotImplementedError

    @property
    def local_rank(self):
        return 0

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def save_optimizer_states(self, fname, dump_optimizer=False):
        raise NotImplementedError

    def load_optimizer_states(self, fname):
        raise NotImplementedError


def is_distributed(name):
    """Whether the store type ``name`` is one of the multi-card stores."""
    return isinstance(name, str) and name.lower().startswith(_DISTRIBUTED)


def create(name="local"):
    """A store by type name (reference: kvstore/base.py ``create``)."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    name = name.lower()
    from .kvstore import KVStore
    from . import horovod  # noqa: F401 (registers the plugins)
    if name in _LOCAL:
        return KVStore(name)
    if name.startswith("dist"):
        from .dist import DistAsyncKVStore, DistKVStore
        if "async" in name:
            return DistAsyncKVStore(name)
        return DistKVStore(name)
    if name in KVStoreBase.kv_registry:
        return KVStoreBase.kv_registry[name]()
    raise MXNetError(f"unknown KVStore type {name!r}")


def _raw(x):
    return getattr(x, "_data", x)


def _assign(target, value):
    """Write ``value`` into ``target`` (a tensor, in place, or an ``mx.np``
    array, rebound), in the target's dtype and on its device."""
    value = _raw(value)
    if isinstance(target, torch.Tensor):
        with torch.no_grad():
            target.copy_(value)
        return
    target._rebind(value.detach().to(device=target._data.device,
                                     dtype=target._data.dtype).clone())


@KVStoreBase.register
class TestStore(KVStoreBase):
    """In-memory single-process store exercising the plugin interface
    (reference: base.py ``TestStore``)."""

    def broadcast(self, key, value, out, priority=0):
        for o in (out if isinstance(out, list) else [out]):
            _assign(o, value)

    def pushpull(self, key, value, out=None, priority=0):
        if not isinstance(value, (list, tuple)):
            if out is not None:
                for o in (out if isinstance(out, list) else [out]):
                    _assign(o, value)
            return
        reduced = _raw(value[0])
        for v in value[1:]:
            reduced = reduced + _raw(v)
        targets = value if out is None else (
            out if isinstance(out, list) else [out])
        for t in targets:
            _assign(t, reduced)

    @staticmethod
    def is_capable(capability):
        return capability in (KVStoreBase.OPTIMIZER,)

    @property
    def type(self):
        return "teststore"
