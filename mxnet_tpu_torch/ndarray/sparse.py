"""Sparse arrays: row_sparse and CSR.

Counterpart of ``mxnet_tpu/ndarray/sparse.py`` (reference parity:
python/mxnet/ndarray/sparse.py ``RowSparseNDArray``, ``CSRNDArray``, the
``row_sparse_array`` / ``csr_matrix`` constructors, ``retain``, sparse
``dot``). A sparse array is a pair (triple) of dense component arrays,
``mx.np`` arrays over tensors: values and indices (and ``indptr``).

The reference's encoding is kept. A ``RowSparseNDArray`` made on the
device (:func:`dedupe_coo`: an embedding's gradient, a sparse ``add``)
has k static slots, k the number of COO entries it came from: the sorted
unique row ids first, then the sentinel ``shape[0]`` with zero rows.
Indices are int32, as the reference's with x64 off (``sparse.py:24``).
:func:`dedupe_coo` and :func:`dot` run on the device and never read nnz
on the host (a stable sort, a prefix sum, ``index_add_`` / ``scatter_``;
no ``torch.unique``, which syncs to size its output), so a CUDA graph can
hold them. The conversions whose size depends on the data (dense to
sparse, ``retain``) read the host, as the reference's do.

Consumers of the encoding write rows through :func:`_set_rows`, which
writes nothing for a sentinel slot, and densify through an extra row that
takes the sentinel slots' zeros.
"""
from __future__ import annotations

import operator

import numpy as onp
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from ..numpy.multiarray import _wrap, array, ndarray

#: the index dtype: the reference's int32 (its tests run with x64 off)
_IDX = torch.int32

__all__ = ["RowSparseNDArray", "CSRNDArray", "row_sparse_array",
           "csr_matrix", "zeros", "retain", "dot", "add", "BaseSparseNDArray",
           "dedupe_coo", "subtract", "multiply", "divide", "empty", "array"]

_dense_array = array


def dedupe_coo(indices, values, n_rows):
    """Sum the duplicate rows of a COO batch on the device: ``(uidx,
    uvals)`` of the same static length k, the distinct row ids (sorted)
    in the leading slots and the sentinel ``n_rows`` with zero rows in the
    rest (reference: ``sparse.py`` ``dedupe_coo``). Tensors in, tensors
    out; duplicates are summed in their order of appearance."""
    indices = torch.as_tensor(getattr(indices, "_data", indices))
    values = torch.as_tensor(getattr(values, "_data", values))
    k = indices.shape[0]
    ids = indices.long()
    if k == 0:
        return ids.to(_IDX), values
    sidx, order = torch.sort(ids, stable=True)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=ids.device),
                       sidx[1:] != sidx[:-1]])
    slot = torch.cumsum(first, 0) - 1          # the group of each entry
    uvals = torch.zeros_like(values).index_add_(0, slot,
                                                values.index_select(0, order))
    uidx = torch.full((k,), n_rows, dtype=torch.long,
                      device=ids.device).scatter_(0, slot, sidx)
    return uidx.to(_IDX), uvals


def _set_rows(table, idx, rows):
    """``table[idx[i]] = rows[i]`` in place for every slot whose id is a
    row of ``table``; a sentinel slot writes nothing. No host read: a
    sentinel slot is sent to the last row with that row's final value
    (the value a real slot writes there, else the row's own), so every
    write to that row agrees."""
    n = table.shape[0]
    if idx.numel() == 0:
        return
    idx = idx.long()
    valid = idx < n
    ones = (1,) * (rows.dim() - 1)
    last = (valid.sum() - 1).clamp(min=0).view(1)   # no 0-d index: no read
    touched = valid.index_select(0, last) \
        & (idx.index_select(0, last) == n - 1)
    final = torch.where(touched.view((1,) + ones), rows.index_select(0, last),
                        table[n - 1:])
    keep = valid.view((-1,) + ones)
    table.index_put_((idx.clamp(max=n - 1),), torch.where(keep, rows, final))


def _rows_of(table, idx):
    """``table``'s rows at ``idx``, a sentinel slot reading the last row
    (its result is never written: :func:`_set_rows`)."""
    return table.index_select(0, idx.long().clamp(max=table.shape[0] - 1))


def _raw(x, dtype=None, ctx=None):
    """A tensor of ``x`` (an ``ndarray``, a tensor or a host value), in
    ``dtype`` where given; a host value lands on ``ctx`` (the current
    context by default)."""
    if isinstance(x, ndarray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(torch_dtype(dtype))
    return _dense_array(x, dtype=dtype, ctx=ctx)._data


def _wrap_raw(x, dtype=None, ctx=None):
    if isinstance(x, ndarray) and dtype is None:
        return x
    return _wrap(_raw(x, dtype, ctx))


class BaseSparseNDArray:
    """The common surface of the sparse types (reference: sparse.py
    ``BaseSparseNDArray``)."""

    @property
    def stype(self):
        raise NotImplementedError

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def context(self):
        return self.data.context

    ctx = context

    def asnumpy(self):
        return self.tostype("default").asnumpy()

    def wait_to_read(self):
        self.data.wait_to_read()
        return self

    def __repr__(self):
        return (f"<{type(self).__name__} {self.shape} "
                f"nnz-storage={tuple(self.data.shape)}>")


class RowSparseNDArray(BaseSparseNDArray):
    """Rows at ``indices`` hold ``data``; every other row is zero
    (reference: sparse.py ``RowSparseNDArray``). data: (k, *row_shape),
    indices: (k,) int32, sorted unique ids, then sentinel slots
    (``shape[0]``, zero rows) where the array came from
    :func:`dedupe_coo`."""

    def __init__(self, data, indices, shape):
        self.data = _wrap_raw(data)
        self.indices = _wrap_raw(indices, _IDX,
                                 ctx=self.data._data.device)
        self.shape = tuple(int(s) for s in shape)
        if self.data.shape[1:] != self.shape[1:]:
            raise MXNetError(
                f"row shape {self.data.shape[1:]} != array row shape "
                f"{self.shape[1:]}")

    @property
    def stype(self):
        return "row_sparse"

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype != "default":
            raise MXNetError(f"cannot convert row_sparse to {stype!r}")
        vals = self.data._data
        # one spare row takes the sentinel slots (add semantics: the ids
        # are unique, so adding into zeros is exact)
        dense = vals.new_zeros((self.shape[0] + 1,) + self.shape[1:])
        dense.index_add_(0, self.indices._data.long().clamp(
            max=self.shape[0]), vals)
        return _wrap(dense[:self.shape[0]])

    def retain(self, row_ids):
        """Keep only the rows in ``row_ids`` (reference: ``sparse.retain``;
        the output's size depends on the data: read on the host)."""
        ids = _raw(row_ids, ctx=self.data._data.device).long()
        keep = torch.isin(self.indices._data.long(), ids).cpu().numpy()
        dev = self.data._data.device
        keep_t = torch.as_tensor(onp.nonzero(keep)[0], device=dev)
        return RowSparseNDArray(self.data._data.index_select(0, keep_t),
                                self.indices._data.index_select(0, keep_t),
                                self.shape)

    def copy(self):
        return RowSparseNDArray(self.data.copy(), self.indices.copy(),
                                self.shape)

    def astype(self, dtype):
        return RowSparseNDArray(self.data.astype(dtype), self.indices,
                                self.shape)

    def __add__(self, other):
        return add(self, other)

    def __radd__(self, other):
        return add(other, self)


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse row matrix (reference: sparse.py
    ``CSRNDArray``): data and indices (nnz,), indptr (m + 1,)."""

    def __init__(self, data, indices, indptr, shape):
        self.data = _wrap_raw(data)
        dev = self.data._data.device
        self.indices = _wrap_raw(indices, _IDX, ctx=dev)
        self.indptr = _wrap_raw(indptr, _IDX, ctx=dev)
        if len(shape) != 2:
            raise MXNetError("CSR arrays are 2-D")
        self.shape = tuple(int(s) for s in shape)

    @property
    def stype(self):
        return "csr"

    def _row_of_nnz(self):
        """The row of each stored value, (nnz,), on the device (the output
        size is given, so nothing is read on the host)."""
        ptr = self.indptr._data.long()
        counts = ptr[1:] - ptr[:-1]
        return torch.repeat_interleave(
            torch.arange(self.shape[0], device=ptr.device), counts,
            output_size=self.data.shape[0])

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype != "default":
            raise MXNetError(f"cannot convert csr to {stype!r}")
        vals = self.data._data
        dense = vals.new_zeros(self.shape)
        dense[self._row_of_nnz(), self.indices._data.long()] = vals
        return _wrap(dense)

    def dot(self, rhs):
        return dot(self, rhs)

    def copy(self):
        return CSRNDArray(self.data.copy(), self.indices.copy(),
                          self.indptr.copy(), self.shape)

    def astype(self, dtype):
        return CSRNDArray(self.data.astype(dtype), self.indices,
                          self.indptr, self.shape)


# -- constructors (reference: sparse.py row_sparse_array / csr_matrix) ---------

def _host(arg1, dtype):
    if isinstance(arg1, ndarray):
        return arg1.asnumpy() if dtype is None \
            else arg1.asnumpy().astype(np_dtype(torch_dtype(dtype)))
    host = onp.asarray(arg1)
    if dtype is not None:
        return host.astype(np_dtype(torch_dtype(dtype)))
    if host.dtype == onp.float64:
        return host.astype(onp.float32)   # the 32-bit rule
    return host


def _place(arg1, ctx):
    if ctx is None and isinstance(arg1, ndarray):
        return arg1._data.device
    return ctx


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A ``RowSparseNDArray`` from one, from ``(data, indices)`` with
    ``shape``, or from a dense array (its non-zero rows, found on the
    host)."""
    if isinstance(arg1, RowSparseNDArray):
        return arg1
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        if shape is None:
            raise MXNetError("shape required with (data, indices)")
        data = _raw(data, dtype, ctx)
        return RowSparseNDArray(data, _raw(indices, _IDX, data.device),
                                shape)
    dense = _host(arg1, dtype)
    nz = onp.where(dense.reshape(dense.shape[0], -1).any(axis=1))[0]
    ctx = _place(arg1, ctx)
    return RowSparseNDArray(_dense_array(dense[nz], ctx=ctx),
                            _dense_array(nz.astype("int32"), ctx=ctx),
                            dense.shape)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A ``CSRNDArray`` from one, from ``(data, indices, indptr)`` with
    ``shape``, or from a dense 2-D array (found on the host)."""
    if isinstance(arg1, CSRNDArray):
        return arg1
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if shape is None:
            raise MXNetError("shape required with (data, indices, indptr)")
        data = _raw(data, dtype, ctx)
        return CSRNDArray(data, _raw(indices, _IDX, data.device),
                          _raw(indptr, _IDX, data.device), shape)
    dense = _host(arg1, dtype)
    if dense.ndim != 2:
        raise MXNetError("CSR arrays are 2-D")
    rows, cols = onp.nonzero(dense)
    indptr = onp.zeros(dense.shape[0] + 1, "int64")
    onp.add.at(indptr, rows + 1, 1)
    indptr = onp.cumsum(indptr)
    ctx = _place(arg1, ctx)
    return CSRNDArray(_dense_array(dense[rows, cols], ctx=ctx),
                      _dense_array(cols.astype("int32"), ctx=ctx),
                      _dense_array(indptr.astype("int32"), ctx=ctx),
                      dense.shape)


def zeros(stype, shape, ctx=None, dtype="float32"):
    """An all-zero array of storage type ``stype`` (reference:
    ``sparse.zeros``)."""
    from ..numpy.multiarray import zeros as _zeros
    if stype == "row_sparse":
        data = _zeros((0,) + tuple(shape[1:]), dtype=dtype, ctx=ctx)
        return RowSparseNDArray(data, data._data.new_zeros((0,), dtype=_IDX),
                                shape)
    if stype == "csr":
        data = _zeros((0,), dtype=dtype, ctx=ctx)
        return CSRNDArray(data, data._data.new_zeros((0,), dtype=_IDX),
                          data._data.new_zeros((shape[0] + 1,), dtype=_IDX),
                          shape)
    if stype == "default":
        return _zeros(shape, dtype=dtype, ctx=ctx)
    raise MXNetError(f"unknown stype {stype!r}")


# -- ops -------------------------------------------------------------------------

def retain(rsp, row_ids):
    if not isinstance(rsp, RowSparseNDArray):
        raise MXNetError("retain expects a RowSparseNDArray")
    return rsp.retain(row_ids)


def dot(lhs, rhs, transpose_a=False):
    """CSR @ dense (reference: sparse ``dot``, src/operator/tensor/dot.cc
    CSR kernels): each stored value times its row of ``rhs``, summed into
    the output by ``index_add_`` on the device."""
    if not isinstance(lhs, CSRNDArray):
        raise MXNetError("sparse dot expects a CSR lhs")
    r = _raw(rhs, ctx=lhs.data._data.device)
    vals = lhs.data._data.unsqueeze(1)
    rows, cols = lhs._row_of_nnz(), lhs.indices._data.long()
    if transpose_a:
        out = r.new_zeros((lhs.shape[1],) + tuple(r.shape[1:]))
        out.index_add_(0, cols, r.index_select(0, rows) * vals)
    else:
        out = r.new_zeros((lhs.shape[0],) + tuple(r.shape[1:]))
        out.index_add_(0, rows, r.index_select(0, cols) * vals)
    return _wrap(out)


def add(a, b):
    """Sparse + sparse / dense. Two row-sparse arrays stay row-sparse
    (their slots concatenated, then :func:`dedupe_coo`: static shapes);
    anything else densifies (the reference's storage fallback)."""
    if isinstance(a, RowSparseNDArray) and isinstance(b, RowSparseNDArray):
        if a.shape != b.shape:
            raise MXNetError("shape mismatch")
        idx = torch.cat([a.indices._data, b.indices._data])
        vals = torch.cat([a.data._data, b.data._data])
        uidx, uvals = dedupe_coo(idx, vals, a.shape[0])
        return RowSparseNDArray(uvals, uidx, a.shape)
    da = a.tostype("default") if isinstance(a, BaseSparseNDArray) else a
    db = b.tostype("default") if isinstance(b, BaseSparseNDArray) else b
    return da + db


def _densify_binary(public_name, op_name):
    """An elementwise op without a sparse-preserving identity: both
    operands densified (the reference's storage fallback,
    sparse.py:1282-1512)."""
    op = getattr(operator, op_name)

    def fn(lhs, rhs):
        dl = lhs.tostype("default") if isinstance(lhs, BaseSparseNDArray) \
            else lhs
        dr = rhs.tostype("default") if isinstance(rhs, BaseSparseNDArray) \
            else rhs
        return op(dl, dr)

    fn.__name__ = public_name
    return fn


subtract = _densify_binary("subtract", "sub")
multiply = _densify_binary("multiply", "mul")
divide = _densify_binary("divide", "truediv")


def empty(stype, shape, ctx=None, dtype=None):
    """An all-zero sparse array (reference sparse.py:1564: sparse storage
    has no uninitialized form)."""
    return zeros(stype, shape, ctx=ctx, dtype=dtype or "float32")


def array(source_array, ctx=None, dtype=None):
    """A sparse array from a sparse source: a copy of a sparse array, or a
    ``scipy.sparse`` matrix as CSR (reference sparse.py:1596). A dense
    source is refused, as in the reference: use ``tostype``."""
    if isinstance(source_array, BaseSparseNDArray):
        out = source_array.copy()
        return out.astype(dtype) if dtype is not None else out
    try:
        import scipy.sparse as sp
        if sp.issparse(source_array):
            csr = source_array.tocsr()
            return csr_matrix((csr.data, csr.indices, csr.indptr),
                              shape=csr.shape, ctx=ctx, dtype=dtype)
    except ImportError:
        pass
    raise MXNetError(
        "sparse.array takes a sparse source (RowSparseNDArray/CSRNDArray "
        "or scipy.sparse); for dense input use mx.nd.array(...).tostype()")


# -- torch's sparse gradients ---------------------------------------------------

def _from_coo(grad):
    """The ``RowSparseNDArray`` of a torch COO gradient (any duplicates,
    any order): its entries through :func:`dedupe_coo`, so k is the
    number of entries, as the reference's sparse cotangents count their
    slots."""
    uidx, uvals = dedupe_coo(grad._indices()[0], grad._values(),
                             grad.shape[0])
    return RowSparseNDArray(uvals, uidx, tuple(grad.shape))


def _cached_rsp(leaf):
    """The ``RowSparseNDArray`` of ``leaf.grad`` (a torch COO gradient),
    made once per gradient tensor and kept on the leaf."""
    grad = leaf.grad
    cached = getattr(leaf, "_mx_rsp", None)
    if cached is None or cached[0] is not grad:
        cached = leaf._mx_rsp = (grad, _from_coo(grad))
    return cached[1]
