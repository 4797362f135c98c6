"""gluon.data datasets (reference: python/mxnet/gluon/data/dataset.py).

Copy of ``mxnet_tpu/gluon/data/dataset.py``. ``RecordFileDataset`` reads
through the Python ``IndexedRecordIO`` (a ``.rec`` / ``.idx`` pair): the
JAX package's native mmap reader is not ported.
"""
from __future__ import annotations

import os
import threading

from ...base import MXNetError


class Dataset:
    """Reference: dataset.py Dataset."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def shard(self, num_shards, index):
        assert 0 <= index < num_shards
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return SimpleDataset([self[i] for i in range(start, end)])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def sample(self, sampler):
        return _SampledDataset(self, sampler)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _SampledDataset(Dataset):
    def __init__(self, data, sampler):
        self._data = data
        self._indices = list(sampler)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._data[self._indices[idx]]


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Zip of arrays (reference: dataset.py ArrayDataset)."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for a in args:
            if len(a) != self._length:
                raise MXNetError("all arrays must have the same length")
            self._data.append(a)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """RecordIO-backed dataset over a ``.rec`` / ``.idx`` pair (reference:
    dataset.py RecordFileDataset over src/io/dataset.cc:61). Pickles into
    a spawned worker, which reopens the file (``MXRecordIO.__setstate__``);
    a lock keeps each seek and its read together under thread workers.
    """

    def __init__(self, filename):
        from ...recordio import IndexedRecordIO
        self.filename = filename
        idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = IndexedRecordIO(idx_file, filename, "r")
        self._lock = threading.Lock()

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_lock"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.Lock()

    def __getitem__(self, idx):
        with self._lock:
            return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
