"""mx.io — legacy data iterators.

Counterpart of ``mxnet_tpu/io/__init__.py`` (reference parity:
python/mxnet/io/io.py, DataIter/DataBatch/NDArrayIter, and the C++
iterators of src/io/: CSVIter, LibSVMIter, MNISTIter). The Gluon
DataLoader is the modern path; these iterators serve MXNet-1.x-style
loops. Batches are ``mx.np`` arrays on the current context; LibSVMIter's
data is a ``CSRNDArray`` (``ndarray.sparse``), as the reference's.
``ImageRecordIter`` and its variants wait for the ``mx.image`` augmenters
and ``ImageIter`` and raise.
"""
from __future__ import annotations

import collections

import numpy as onp

from ..base import MXNetError
from ..numpy.multiarray import array as _array
from ..numpy.multiarray import ndarray

DataDesc = collections.namedtuple("DataDesc", ["name", "shape"])


class DataBatch:
    """Reference: io.py DataBatch."""

    def __init__(self, data, label=None, pad=None, index=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Reference: io.py DataIter."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    __next__ = next

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


class NDArrayIter(DataIter):
    """Reference: io.py NDArrayIter (dict/list/array data, shuffle,
    last_batch_handle pad/discard/roll_over)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0] if self.data else 0
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self.idx = onp.arange(self.num_data)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]))
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]))
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            onp.random.shuffle(self.idx)
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _slice(self, arrays):
        out = []
        for _, v in arrays:
            lo = self.cursor
            hi = min(self.cursor + self.batch_size, self.num_data)
            sel = self.idx[lo:hi]
            part = v[sel]
            if hi - lo < self.batch_size and self.last_batch_handle == "pad":
                extra = self.batch_size - (hi - lo)
                pad_sel = self.idx[:extra]
                part = onp.concatenate([part, v[pad_sel]])
            out.append(_array(part))
        return out

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


def _init_data(data, allow_empty, default_name):
    if data is None:
        if not allow_empty:
            raise MXNetError("data required")
        return []
    if isinstance(data, (onp.ndarray, ndarray)):
        data = {default_name: data}
    if isinstance(data, (list, tuple)):
        data = {f"{default_name}_{i}" if i else default_name: d
                for i, d in enumerate(data)}
    out = []
    for k, v in data.items():
        arr = v.asnumpy() if isinstance(v, ndarray) else onp.asarray(v)
        out.append((k, arr))
    return out


class ResizeIter(DataIter):
    """Reference: io.py ResizeIter (epoch-resize wrapper)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur == self.size:
            raise StopIteration
        self.cur += 1
        try:
            return self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            return self.data_iter.next()

    __next__ = next


class PrefetchingIter(DataIter):
    """Reference: io.py PrefetchingIter (threaded prefetch)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        import queue
        import threading
        self.iters = iters if isinstance(iters, list) else [iters]
        super().__init__(self.iters[0].batch_size)
        self._queue = queue.Queue(maxsize=2)
        self._stop = False
        self._thread = None
        self._start()

    def _start(self):
        import threading

        from ..context import current_context
        ctx = current_context()  # the thread makes the caller's arrays

        def _worker():
            try:
                with ctx:
                    self._fill()
            finally:
                self._queue.put(None)
        self._thread = threading.Thread(target=_worker, daemon=True)
        self._thread.start()

    def _fill(self):
        for batch in self.iters[0]:
            if self._stop:
                return
            self._queue.put(batch)

    def reset(self):
        self._stop = True
        while not self._queue.empty():
            self._queue.get()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._stop = False
        for it in self.iters:
            it.reset()
        self._start()

    def next(self):
        batch = self._queue.get()
        if batch is None:
            raise StopIteration
        return batch

    __next__ = next


class CSVIter(DataIter):
    """CSV file iterator (reference: src/io/iter_csv.cc, exposed as
    mx.io.CSVIter).  Loads the csv eagerly (host memory) and batches;
    `round_batch` wraps the tail batch with rows from the start, like the
    reference's default behavior."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 dtype="float32", **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self.label_shape = tuple(label_shape)
        self._data = onp.loadtxt(data_csv, delimiter=",",
                                 dtype=dtype, ndmin=2)
        n = len(self._data)
        self._data = self._data.reshape((n,) + self.data_shape)
        if label_csv is not None:
            self._label = onp.loadtxt(label_csv, delimiter=",",
                                      dtype="float32", ndmin=2)
            self._label = self._label.reshape((n,) + self.label_shape)
        else:
            self._label = onp.zeros((n,) + self.label_shape, "float32")
        self._round = round_batch
        self._cursor = 0

    @property
    def provide_data(self):
        return [("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [("label", (self.batch_size,) + self.label_shape)]

    def reset(self):
        self._cursor = 0

    def next(self):
        n = len(self._data)
        if self._cursor >= n:
            raise StopIteration
        idx = onp.arange(self._cursor, self._cursor + self.batch_size)
        self._cursor += self.batch_size
        pad = int(max(0, idx[-1] + 1 - n))
        if pad and not self._round:
            # short tail batch with no padding rows present
            idx, pad = idx[idx < n], 0
        idx = idx % n
        return DataBatch([_array(self._data[idx])],
                         [_array(self._label[idx])], pad=pad)

    __next__ = next


class LibSVMIter(DataIter):
    """LibSVM sparse-format iterator (reference: src/io/iter_libsvm.cc).
    The data of a batch is a ``CSRNDArray`` on the current context (the
    reference's CSR storage for the data field)."""

    def __init__(self, data_libsvm, data_shape, batch_size=1,
                 round_batch=True, **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        indptr, indices, values, labels = [0], [], [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                for kv in parts[1:]:
                    k, v = kv.split(":")
                    indices.append(int(k))
                    values.append(float(v))
                indptr.append(len(indices))
        self._indptr = onp.asarray(indptr, "int64")
        self._indices = onp.asarray(indices, "int64")
        self._values = onp.asarray(values, "float32")
        self._labels = onp.asarray(labels, "float32")
        self._round = round_batch
        self._cursor = 0

    @property
    def provide_data(self):
        return [("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [("label", (self.batch_size,))]

    def reset(self):
        self._cursor = 0

    def next(self):
        from ..ndarray import sparse as _sp
        n = len(self._labels)
        if self._cursor >= n:
            raise StopIteration
        rows = onp.arange(self._cursor, self._cursor + self.batch_size)
        self._cursor += self.batch_size
        pad = int(max(0, rows[-1] + 1 - n))
        if pad and not self._round:
            # short tail batch with no wrapped rows
            rows, pad = rows[rows < n], 0
        rows = rows % n
        ptr = [0]
        idxs, vals = [], []
        for r in rows:
            lo, hi = self._indptr[r], self._indptr[r + 1]
            idxs.append(self._indices[lo:hi])
            vals.append(self._values[lo:hi])
            ptr.append(ptr[-1] + (hi - lo))
        data = _sp.csr_matrix(
            (onp.concatenate(vals) if vals else onp.zeros(0, "float32"),
             onp.concatenate(idxs) if idxs else onp.zeros(0, "int64"),
             onp.asarray(ptr, "int64")),
            shape=(len(rows),) + self.data_shape)
        return DataBatch([data], [_array(self._labels[rows])], pad=pad)

    __next__ = next


class MNISTIter(DataIter):
    """MNIST idx-format iterator (reference: src/io/iter_mnist.cc).
    Reads local `image` / `label` idx(.gz) files."""

    def __init__(self, image, label, batch_size=1, shuffle=False,
                 flat=False, seed=0, **kwargs):
        super().__init__(batch_size)
        import gzip
        import struct as _struct

        def read_idx(path):
            op = gzip.open if path.endswith(".gz") else open
            with op(path, "rb") as f:
                raw = f.read()
            magic, = _struct.unpack(">I", raw[:4])
            ndim = magic & 0xFF
            dims = _struct.unpack(">" + "I" * ndim, raw[4:4 + 4 * ndim])
            return onp.frombuffer(raw, onp.uint8,
                                  offset=4 + 4 * ndim).reshape(dims)

        self._images = read_idx(image).astype("float32") / 255.0
        self._labels = read_idx(label).astype("float32")
        if flat:
            self._images = self._images.reshape(len(self._images), -1)
        else:
            self._images = self._images[:, None, :, :]  # NCHW
        self._order = onp.arange(len(self._images))
        self._shuffle = shuffle
        self._sample_shape = self._images.shape[1:]
        self._rng = onp.random.RandomState(seed)
        self._cursor = 0
        self.reset()

    @property
    def provide_data(self):
        return [("data", (self.batch_size,) + self._sample_shape)]

    @property
    def provide_label(self):
        return [("label", (self.batch_size,))]

    def reset(self):
        self._cursor = 0
        if self._shuffle:
            self._rng.shuffle(self._order)

    def next(self):
        n = len(self._order)
        if self._cursor + self.batch_size > n:
            raise StopIteration
        idx = self._order[self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        return DataBatch([_array(self._images[idx])],
                         [_array(self._labels[idx])], pad=0)

    __next__ = next


def _needs_image_iter(name):
    def missing(*args, **kwargs):
        raise MXNetError(
            f"mx.io.{name} maps onto mx.image.ImageIter and the augmenters "
            "of CreateAugmenter, which are not ported yet; read the .rec "
            "with gluon.data.vision.ImageRecordDataset and a DataLoader")
    missing.__name__ = name
    return missing


ImageRecordIter = _needs_image_iter("ImageRecordIter")
ImageDetRecordIter = _needs_image_iter("ImageDetRecordIter")
ImageRecordUInt8Iter = _needs_image_iter("ImageRecordUInt8Iter")
ImageRecordInt8Iter = ImageRecordUInt8Iter
ImageRecordIter_v1 = ImageRecordIter
ImageRecordUInt8Iter_v1 = ImageRecordUInt8Iter
