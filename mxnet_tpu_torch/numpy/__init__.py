"""``mx.np``: the NumPy-compatible array namespace of the port.

Counterpart of ``mxnet_tpu/numpy/`` (``__init__.py``, ``multiarray.py``,
``random.py``, ``linalg.py``). The reference resolves any NumPy name lazily
to a wrapped ``jnp`` function (``__init__.py:83-103``); torch has many
NumPy names whose rules differ (integer widths, ``median``, the windows),
so the port keeps an explicit table instead: the 187 functions of the
reference's frontend (``tests/test_op_coverage.py`` ``REF_NP``), the
reference's own overrides (``concat``, ``asarray``, ``asnumpy``,
``meshgrid``, ``may_share_memory`` / ``shares_memory``), ``floor_divide``,
``left_shift`` / ``right_shift`` and the dtype objects. A name outside the
table raises ``AttributeError``.

Each function takes ``ndarray``s (or tensors, host arrays and Python
scalars) and returns ``ndarray``s through ``multiarray._invoke`` under its
own name (the AMP policy's op lists); ``out=`` writes through a
destination array (``multiarray._writeback``). The creation functions and
the windows take ``ctx=`` / ``device=`` and otherwise place on the current
context (``with mx.cpu():`` / ``with mx.gpu(0):``, else ``cuda:0``).
"""
from __future__ import annotations

import functools

import numpy as onp

from ..base import bfloat16  # noqa: F401
from ..context import resolve_device
from . import _ops
from .multiarray import (  # noqa: F401
    _invoke, _wrap_out, _writeback, arange, array, e,
    empty, empty_like, euler_gamma, eye, from_dlpack, fromnumpy, full,
    full_like, identity, inf, linspace, logspace, nan, ndarray, newaxis, ones,
    ones_like, pi, zeros, zeros_like)

# dtype objects, as ``np.float32`` is used with the reference
float16 = onp.float16
float32 = onp.float32
float64 = onp.float64
int8 = onp.int8
int16 = onp.int16
int32 = onp.int32
int64 = onp.int64
uint8 = onp.uint8
uint16 = onp.uint16
uint32 = onp.uint32
uint64 = onp.uint64
bool_ = onp.bool_
dtype = onp.dtype


def _make_op(fn, name):
    @functools.wraps(fn)
    def op(*args, out=None, ctx=None, device=None, **kwargs):
        return _writeback(out, _invoke(fn, args, kwargs, name=name))
    op.__name__ = name
    op.__qualname__ = name
    return op


def _make_placed(fn, name):
    """A function that makes an array from nothing but options: it is
    placed on ``ctx`` / ``device``, else the current context."""
    @functools.wraps(fn)
    def op(*args, ctx=None, device=None, **kwargs):
        dev = resolve_device(device if device is not None else ctx)
        return _wrap_out(fn(*args, device=dev, **kwargs))
    op.__name__ = name
    op.__qualname__ = name
    return op


def _seq_op(fn, name):
    """A function over a sequence of arrays (its first argument)."""
    @functools.wraps(fn)
    def op(seq, *args, out=None, **kwargs):
        return _writeback(out, _invoke(
            lambda xs, *a, **k: fn(list(xs), *a, **k), (tuple(seq),) + args,
            kwargs, name=name))
    op.__name__ = name
    op.__qualname__ = name
    return op


#: name -> the implementation over tensors (``_ops``); each becomes a
#: public function through ``_make_op``
_ELEMENTWISE_AND_MORE = (
    "abs absolute add all amax amin any append arccos arccosh arcsin "
    "arcsinh arctan arctan2 arctanh argmax argmin argsort around "
    "atleast_1d atleast_2d atleast_3d average "
    "bincount bitwise_and bitwise_invert bitwise_not bitwise_or bitwise_xor "
    "broadcast_to cbrt ceil clip copysign cos cosh cross cumsum deg2rad "
    "degrees delete diag diagflat diagonal diff divide dot dsplit "
    "ediff1d einsum equal exp expand_dims expm1 fabs fill_diagonal fix "
    "flatnonzero "
    "flip fliplr flipud floor floor_divide fmax fmin fmod gcd greater "
    "greater_equal histogram hsplit hypot inner insert interp invert "
    "isfinite isinf isnan isneginf isposinf kron lcm ldexp left_shift less "
    "less_equal log log10 log1p log2 logical_and logical_not logical_or "
    "logical_xor matmul max maximum mean median meshgrid min minimum mod "
    "moveaxis "
    "multiply nan_to_num nanprod nansum negative nonzero not_equal outer pad "
    "percentile polyval power prod quantile rad2deg radians ravel "
    "reciprocal remainder repeat reshape resize right_shift rint roll "
    "rollaxis rot90 round sign sin sinh sort split array_split sqrt square "
    "squeeze std subtract sum swapaxes take tan tanh tensordot tile trace "
    "transpose tril triu true_divide trunc unique unravel_index var vdot "
    "vsplit where"
).split()
_SEQUENCE = ("concatenate stack vstack row_stack hstack dstack "
             "column_stack").split()
_PLACED = "blackman hamming hanning tri indices tril_indices triu_indices" \
    .split()

_TABLE = {}
for _name in _ELEMENTWISE_AND_MORE:
    _TABLE[_name] = _make_op(getattr(_ops, _name), _name)
for _name in _SEQUENCE:
    _TABLE[_name] = _seq_op(getattr(_ops, _name), _name)
for _name in _PLACED:
    _TABLE[_name] = _make_placed(getattr(_ops, _name), _name)


_TABLE.update(
    concat=_TABLE["concatenate"],
    array=array, asarray=lambda obj, dtype=None, ctx=None, device=None:
    obj if isinstance(obj, ndarray) and dtype is None and ctx is None
    and device is None else array(obj, dtype, ctx, device),
    arange=arange, empty=empty, empty_like=empty_like, eye=eye, full=full,
    full_like=full_like, identity=identity, linspace=linspace,
    logspace=logspace, ones=ones, ones_like=ones_like, zeros=zeros,
    zeros_like=zeros_like, fromnumpy=fromnumpy, from_dlpack=from_dlpack)


def asnumpy(a):
    return a.asnumpy() if isinstance(a, ndarray) else a


def may_share_memory(a, b, max_work=None):
    """Whether two arrays may alias (reference: wrapper identity; here
    whether their tensors share storage)."""
    if not (isinstance(a, ndarray) and isinstance(b, ndarray)):
        return False
    return a._data.untyped_storage().data_ptr() == \
        b._data.untyped_storage().data_ptr()


shares_memory = may_share_memory
_TABLE.update(asnumpy=asnumpy, may_share_memory=may_share_memory,
              shares_memory=shares_memory)
globals().update(_TABLE)

from . import linalg, random  # noqa: E402,F401


def __getattr__(name):
    raise AttributeError(
        f"module 'mxnet_tpu_torch.numpy' has no attribute {name!r} (the "
        "port's mx.np holds the reference's op surface as an explicit "
        "table; other NumPy names are not ported yet: ROADMAP.md Queue 1, "
        "item 9)")


__all__ = sorted(_TABLE) + ["ndarray", "linalg", "random", "float16",
                            "float32", "float64", "bfloat16", "int8",
                            "int16", "int32", "int64", "uint8", "uint16",
                            "uint32", "uint64", "bool_", "dtype", "newaxis",
                            "pi", "e", "inf", "nan", "euler_gamma"]
