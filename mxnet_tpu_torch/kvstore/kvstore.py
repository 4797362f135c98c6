"""The single-process KVStore ("local", "device", "nccl") on one card.

Counterpart of ``mxnet_tpu/kvstore/kvstore.py`` (reference: src/kvstore/
kvstore_local.h): values are tensors (``mx.np`` arrays are taken and
written back too); ``push`` sums a list of values, then runs the updater
on the stored value (``set_optimizer``: the optimizer runs inside the
store, as ``Trainer(update_on_kvstore=True)`` uses it) or stores the sum;
``pull`` copies the stored value out; ``pushpull`` pushes and writes the
result out; ``broadcast`` is ``init`` then ``pull``. Row-sparse values
(``RowSparseNDArray``) reduce sparsely and reach the optimizer as they
are, so a ``lazy_update`` rule touches their rows only;
``row_sparse_pull`` pulls the rows of given ids.

Gradient compression (``set_gradient_compression``) quantizes each
pushed sum with its key's residual before the updater or the store sees
it, as the reference's ``dist_sync`` store does on a world of one worker
(its ``_merged``: reduce, quantize, then the cross-process sum, the
identity on one worker). The reference's local store raises instead: a
deliberate difference (ROADMAP.md Queue 3), since one card has no other.
"""
from __future__ import annotations

import os

import torch

from ..base import MXNetError
from .base import KVStoreBase, _assign, _raw

__all__ = ["KVStore"]


class KVStore(KVStoreBase):
    """In-process key-value store (reference: kvstore.py ``KVStore``)."""

    def __init__(self, name="device"):
        self._type = name
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._gc = None

    @property
    def type(self):
        return self._type

    @staticmethod
    def is_capable(capability):
        return capability in (KVStoreBase.OPTIMIZER,)

    @staticmethod
    def _normalize(key, value):
        if isinstance(key, (list, tuple)):
            return list(key), list(value)
        return [key], [value]

    @staticmethod
    def _key_int(k):
        try:
            return int(k)
        except (TypeError, ValueError):
            return k

    def _check(self, k):
        if k not in self._store:
            raise MXNetError(f"key {k} not initialized")

    # -- core ops ------------------------------------------------------------
    def init(self, key, value):
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            if k not in self._store:
                self._store[k] = _raw(v).detach().clone()

    def _merged(self, k, vs):
        """The sum of one key's pushed values, quantized with the key's
        residual when compression is set. Row-sparse values reduce
        sparsely (reference: comm.h ``ReduceRowSparse``)."""
        from ..ndarray.sparse import BaseSparseNDArray, add
        parts = list(vs) if isinstance(vs, (list, tuple)) else [vs]
        if any(isinstance(v, BaseSparseNDArray) for v in parts):
            merged = parts[0]
            for v in parts[1:]:
                merged = add(merged, v)
            if self._gc is not None:
                raise MXNetError("gradient compression takes dense values, "
                                 "not row_sparse ones")
            return merged if isinstance(merged, BaseSparseNDArray) \
                else _raw(merged)
        merged = _raw(parts[0])
        for v in parts[1:]:
            merged = merged + _raw(v)
        if self._gc is not None:
            merged = self._gc.quantize(k, merged)
        return merged

    @torch.no_grad()
    def push(self, key, value, priority=0):
        """Reduce each key's values and update the stored value with them
        (the optimizer's rule where one is set, else the sum is stored).
        A row-sparse sum goes to the optimizer as it is (its lazy rule
        touches its rows only), or is stored densified."""
        keys, values = self._normalize(key, value)
        for k, vs in zip(keys, values):
            self._check(k)
            merged = self._merged(k, vs)
            if self._updater is not None:
                self._updater(self._key_int(k), merged, self._store[k])
            else:
                if not isinstance(merged, torch.Tensor):
                    merged = merged.tostype("default")._data
                self._store[k].copy_(merged)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's value into ``out`` (reference: kvstore.py
        ``pull``; ``ignore_sparse`` as the reference takes it: row-sparse
        values are pulled with :meth:`row_sparse_pull`)."""
        keys, outs = self._normalize(key, out)
        for k, o in zip(keys, outs):
            self._check(k)
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                if t is not self._store[k]:
                    _assign(t, self._store[k])

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` of each key (duplicates dropped,
        sorted; the count is read on the host) as a ``RowSparseNDArray``
        (reference: kvstore.py ``row_sparse_pull`` over kvstore.h
        ``PullRowSparse``), written into the ``out`` targets too: a
        row-sparse target takes the rows, a dense one those rows and zeros
        elsewhere. Without ``row_ids`` it is :meth:`pull`."""
        if row_ids is None:
            return self.pull(key, out=out, priority=priority)
        from ..ndarray.sparse import RowSparseNDArray
        keys, _ = self._normalize(key, None)
        rids = (row_ids if isinstance(row_ids, (list, tuple))
                else [row_ids] * len(keys))
        results = []
        for k, rid in zip(keys, rids):
            self._check(k)
            src = self._store[k]
            ids = torch.unique(torch.as_tensor(_raw(rid),
                                               device=src.device).long())
            results.append(RowSparseNDArray(src.index_select(0, ids), ids,
                                            tuple(src.shape)))
        if out is not None:
            _, outs = self._normalize(key, out)
            for rsp, o in zip(results, outs):
                for t in (o if isinstance(o, (list, tuple)) else [o]):
                    if isinstance(t, RowSparseNDArray):
                        t.data, t.indices, t.shape = (rsp.data, rsp.indices,
                                                      rsp.shape)
                    else:
                        _assign(t, rsp.tostype("default"))
        return results[0] if not isinstance(key, (list, tuple)) else results

    def _bind(self, key, tensor):
        """Make ``tensor`` itself (no copy) the value of ``key``: the
        Trainer binds a row-sparse parameter's weight, so the store's lazy
        update writes the weight's touched rows in place and nothing is
        pulled back."""
        self._store[key] = tensor

    @torch.no_grad()
    def pushpull(self, key, value, out=None, priority=0):
        """Push, then write each key's result out (reference: kvstore.h
        ``PushPull``): the stored value with an updater, else the pushed
        sum, which the store then does not keep (as in the reference)."""
        keys, values = self._normalize(key, value)
        results = []
        for k, vs in zip(keys, values):
            merged = self._merged(k, vs)
            if self._updater is not None:
                self._check(k)
                self._updater(self._key_int(k), merged, self._store[k])
                merged = self._store[k]
            results.append(merged)
        if out is None:
            return
        _, outs = self._normalize(key, out)
        for merged, o in zip(results, outs):
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                _assign(t, merged)

    def broadcast(self, key, value, out, priority=0):
        """``init`` then ``pull`` (reference: base.py ``broadcast``)."""
        self.init(key, value)
        self.pull(key, out=out, priority=priority)

    # -- updater and optimizer ---------------------------------------------------
    def _set_updater(self, updater):
        self._updater = updater

    set_updater = _set_updater

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` inside the store: each push updates the
        stored value (reference: kvstore.py ``set_optimizer``)."""
        from ..optimizer import get_updater
        self._optimizer = optimizer
        self._updater = get_updater(optimizer)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no updater/optimizer set")
        tmp = f"{fname}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fname)

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no updater/optimizer set")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read(), self._store)
        self._optimizer = self._updater.optimizer

    def set_gradient_compression(self, compression_params):
        """1-bit or 2-bit compression of every push (``{"type": "2bit",
        "threshold": 0.5}``), as the reference's ``dist_sync`` store
        applies it on one worker."""
        from .gradient_compression import GradientCompression
        self._gc = GradientCompression(**dict(compression_params or {}))
