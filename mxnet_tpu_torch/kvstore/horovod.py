"""Horovod / BytePS-style plugin stores.

Counterpart of ``mxnet_tpu/kvstore/horovod.py`` (reference:
python/mxnet/kvstore/horovod.py and byteps.py, MPI-launched all-reduce
plugins registered through ``KVStoreBase.register``). The collectives are
the process group's, so these are the dist store under the plugin names
``kv.create("horovod")`` / ``kv.create("byteps")`` call sites use: a
push all-reduces over every process, as Horovod's ``allreduce_`` does.
"""
from __future__ import annotations

from .base import KVStoreBase, _assign
from .dist import DistKVStore

__all__ = ["Horovod", "BytePS"]


@KVStoreBase.register
class Horovod(DistKVStore):
    def __init__(self):
        super().__init__("horovod")

    def broadcast_parameters(self, params, root_rank=0):
        """Every rank starts from ``root_rank``'s values (reference:
        horovod.py ``broadcast_parameters``)."""
        from ..parallel.collectives import _dist
        dist = _dist()
        for k, v in params.items():
            self.init(k, v)
            t = self._store[k]
            if self._nprocs > 1:
                # gloo broadcasts CUDA tensors itself (collectives.py)
                dist.broadcast(t, src=root_rank)
            _assign(v, t)


@KVStoreBase.register
class BytePS(DistKVStore):
    def __init__(self):
        super().__init__("byteps")
