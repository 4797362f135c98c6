"""``mx.dlpack``: zero-copy exchange of arrays.

Counterpart of ``mxnet_tpu/dlpack.py`` (reference: python/mxnet/dlpack.py:
``ndarray_to_dlpack_for_read`` / ``_for_write`` and
``ndarray_from_dlpack``), over ``torch.utils.dlpack``: no copy either
way. A capsule exported for write shares the array's storage, so a writer
changes the array in place (the one place the port lets that happen); one
exported for read must be treated as read-only.
"""
from __future__ import annotations

from torch.utils import dlpack as _dlpack

from .numpy.multiarray import from_dlpack as ndarray_from_dlpack
from .numpy.multiarray import ndarray

__all__ = ["ndarray_to_dlpack_for_read", "ndarray_to_dlpack_for_write",
           "ndarray_from_dlpack", "from_dlpack", "to_dlpack_for_read",
           "to_dlpack_for_write"]


def ndarray_to_dlpack_for_read(data: ndarray):
    """A DLPack capsule of the array, after its pending work (read-only for
    the consumer)."""
    data.wait_to_read()
    return _dlpack.to_dlpack(data._data.detach())


def ndarray_to_dlpack_for_write(data: ndarray):
    """A DLPack capsule of the array's storage, which the consumer may
    write."""
    return _dlpack.to_dlpack(data._data.detach())


to_dlpack_for_read = ndarray_to_dlpack_for_read
to_dlpack_for_write = ndarray_to_dlpack_for_write
from_dlpack = ndarray_from_dlpack
