"""The ``mx.np`` functions over ``torch.Tensor``, with the reference's rules.

Each function here takes tensors (``_invoke`` has unwrapped the
``ndarray`` arguments and moved host arrays onto the device), Python
scalars and plain options, and returns tensors. Where a torch call's rule
differs from the reference's (``jax.numpy`` in its 32-bit mode), the
function gives the reference's:

- **dtypes.** A reduction of bool / int8 / int16 / int32 sums in int32 and
  of an unsigned type in uint32 (torch: int64); ``mean`` / ``std`` /
  ``var`` of integers give float32 (torch raises); an index result
  (``argmax``, ``nonzero``, ``unique``'s indices, ``bincount``, ...) is
  int32. Where an input is 64-bit the reference runs in its x64 mode, so
  these become int64 / float64. Transcendentals of integers give float32
  (float64 from a 64-bit input). A Python scalar is weakly typed: it
  takes the array's dtype where that holds it (``bool`` + 1 gives int32,
  int32 + 2.5 float32).
- **values.** ``median`` / ``percentile`` / ``quantile`` interpolate
  linearly between the two middle order statistics (``torch.median``
  gives the lower); the window functions are symmetric (``torch``'s are
  periodic by default); ``take`` fills out-of-range indices (NaN for
  floats) as ``jnp.take`` does.

A Python scalar goes to torch as a number where torch takes one, and is
otherwise made a 0-d tensor on the device by ``torch.full`` (a fill
kernel): nothing here copies from the host or synchronizes, so a
hybridized forward written in ``mx.np`` captures into a CUDA graph.
"""
from __future__ import annotations

import builtins
import math

import torch

from ..base import MXNetError, torch_dtype

_INT32_ACC = (torch.bool, torch.int8, torch.int16, torch.int32)
_UINT_ACC = (torch.uint8, torch.uint16, torch.uint32)
_X64 = (torch.int64, torch.uint64, torch.float64, torch.complex128)


# -- dtype rules ----------------------------------------------------------------

def _is_t(x):
    return isinstance(x, torch.Tensor)


def _x64(*xs):
    """Whether the reference would run in its x64 mode: an input is
    64-bit."""
    return builtins.any(_is_t(x) and x.dtype in _X64 for x in xs)


def _inexact(dt):
    return dt.is_floating_point or dt.is_complex


def _float_dtype(*xs):
    """The floating dtype integer inputs become: float32, or float64 in
    x64 mode."""
    return torch.float64 if _x64(*xs) else torch.float32


def _to_float(x):
    """``x`` as a floating tensor (integers and bools by the rule above)."""
    if _inexact(x.dtype):
        return x
    return x.to(_float_dtype(x))


def _index_dtype(*xs):
    return torch.int64 if _x64(*xs) else torch.int32


def _weak(t, v):
    """Result dtype of tensor ``t`` with Python scalar ``v`` (the scalar is
    weakly typed)."""
    dt = t.dtype
    if isinstance(v, bool):
        return dt
    if isinstance(v, int):
        return torch.int32 if dt is torch.bool else dt
    if isinstance(v, float):
        return dt if _inexact(dt) else _float_dtype(t)
    if isinstance(v, complex):
        if dt.is_complex:
            return dt
        return torch.complex128 if dt in _X64 else torch.complex64
    raise MXNetError(f"unsupported operand {v!r}")


def _scalar(v, like, dtype=None):
    """Python scalar ``v`` as a 0-d tensor on ``like``'s device (a fill
    kernel, no host copy)."""
    return torch.full((), v, dtype=dtype or _weak(like, v),
                      device=like.device)


def _default_device():
    from ..context import resolve_device
    return resolve_device(None)


def _lone_scalar(v, dtype=None):
    """A 0-d tensor of a Python scalar with no array beside it (the
    reference gives a 0-d array of the scalar's 32-bit dtype)."""
    from ..base import scalar_dtype
    return torch.full((), v, dtype=dtype or scalar_dtype(v),
                      device=_default_device())


def _tensors(a, b):
    """(a, b) with a Python scalar made a tensor by the weak rule."""
    if _is_t(a):
        return a, (b if _is_t(b) else _scalar(b, a))
    if _is_t(b):
        return _scalar(a, b), b
    a = _lone_scalar(a)
    return a, _scalar(b, a)


def _t(x):
    """``x`` as a tensor (a lone Python scalar by the 32-bit rule)."""
    return x if _is_t(x) else _lone_scalar(x)


def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (tuple, list)):
        return tuple(a % ndim if ndim else 0 for a in axis)
    return (axis % ndim if ndim else 0,)


def _acc_dtype(x, dtype):
    """The result dtype of sum / prod / cumsum / trace."""
    if dtype is not None:
        return torch_dtype(dtype)
    if x.dtype in _INT32_ACC:
        return torch.int32
    if x.dtype in _UINT_ACC:
        return torch.uint32
    return x.dtype


def _mean_dtype(x, dtype):
    if dtype is not None:
        return torch_dtype(dtype)
    return x.dtype if _inexact(x.dtype) else _float_dtype(x)


# -- elementwise ------------------------------------------------------------------

def _unary_float(fn):
    def op(x):
        return fn(_to_float(_t(x)))
    return op


sin = _unary_float(torch.sin)
cos = _unary_float(torch.cos)
tan = _unary_float(torch.tan)
sinh = _unary_float(torch.sinh)
cosh = _unary_float(torch.cosh)
tanh = _unary_float(torch.tanh)
exp = _unary_float(torch.exp)
expm1 = _unary_float(torch.expm1)
log = _unary_float(torch.log)
log10 = _unary_float(torch.log10)
log1p = _unary_float(torch.log1p)
log2 = _unary_float(torch.log2)
sqrt = _unary_float(torch.sqrt)
arcsin = _unary_float(torch.asin)
arccos = _unary_float(torch.acos)
arctan = _unary_float(torch.atan)
arcsinh = _unary_float(torch.asinh)
arccosh = _unary_float(torch.acosh)
arctanh = _unary_float(torch.atanh)
deg2rad = radians = _unary_float(torch.deg2rad)
rad2deg = degrees = _unary_float(torch.rad2deg)
reciprocal = _unary_float(torch.reciprocal)
fabs = _unary_float(torch.abs)
rint = _unary_float(torch.round)
sigmoid = _unary_float(torch.sigmoid)


@_unary_float
def cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def negative(x):
    return torch.neg(_t(x))


def absolute(x):
    x = _t(x)
    return x if x.dtype is torch.bool else torch.abs(x)


abs = absolute  # noqa: A001 - the reference's name


def square(x):
    x = _t(x)
    if x.dtype is torch.bool:
        x = x.to(torch.int32)
    return x * x


def sign(x):
    x = _t(x)
    return x if x.dtype is torch.bool else torch.sign(x)


def _int_keeps(fn):
    """Rounding functions: integer inputs come back as they are."""
    def op(x):
        x = _t(x)
        return fn(x) if _inexact(x.dtype) else x
    return op


ceil = _int_keeps(torch.ceil)
floor = _int_keeps(torch.floor)
trunc = fix = _int_keeps(torch.trunc)


def around(a, decimals=0):
    a = _t(a)
    if not _inexact(a.dtype):
        return a
    return torch.round(a, decimals=decimals)


round = around  # noqa: A001 - the reference's name


def invert(x):
    return torch.bitwise_not(_t(x))


bitwise_not = bitwise_invert = invert


def logical_not(x):
    return torch.logical_not(_t(x))


def isfinite(x):
    return torch.isfinite(_t(x))


def isinf(x):
    return torch.isinf(_t(x))


def isnan(x):
    return torch.isnan(_t(x))


def isneginf(x):
    return torch.isneginf(_t(x))


def isposinf(x):
    return torch.isposinf(_t(x))


def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    x = _t(x)
    if not _inexact(x.dtype):
        return x
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


# -- binary -----------------------------------------------------------------------

def _fixup_bool_int(a, b):
    """jnp's rule for a bool array with a Python int: int32 (torch:
    int64)."""
    if _is_t(a) and a.dtype is torch.bool and isinstance(b, int) \
            and not isinstance(b, bool):
        return a.to(torch.int32)
    return a


def _arith(fn, rfn=None):
    """Binary op torch takes a Python scalar for (on either side where
    ``rfn`` computes ``scalar op tensor``)."""
    def op(a, b):
        if _is_t(a):
            return fn(_fixup_bool_int(a, b), b)
        if _is_t(b):
            b = _fixup_bool_int(b, a)
            if rfn is not None:
                return rfn(b, a)
            return fn(_scalar(a, b), b)
        return fn(_lone_scalar(a), b)
    return op


add = _arith(torch.add, lambda t, s: torch.add(t, s))
multiply = _arith(torch.mul, lambda t, s: torch.mul(t, s))
subtract = _arith(torch.sub, lambda t, s: torch.rsub(t, s))
remainder = mod = _arith(torch.remainder)
fmod = _arith(torch.fmod)
floor_divide = _arith(torch.floor_divide)
bitwise_and = _arith(torch.bitwise_and, lambda t, s: torch.bitwise_and(t, s))
bitwise_or = _arith(torch.bitwise_or, lambda t, s: torch.bitwise_or(t, s))
bitwise_xor = _arith(torch.bitwise_xor, lambda t, s: torch.bitwise_xor(t, s))
left_shift = _arith(torch.bitwise_left_shift)
right_shift = _arith(torch.bitwise_right_shift)
equal = _arith(torch.eq, lambda t, s: torch.eq(t, s))
not_equal = _arith(torch.ne, lambda t, s: torch.ne(t, s))
less = _arith(torch.lt, lambda t, s: torch.gt(t, s))
less_equal = _arith(torch.le, lambda t, s: torch.ge(t, s))
greater = _arith(torch.gt, lambda t, s: torch.lt(t, s))
greater_equal = _arith(torch.ge, lambda t, s: torch.le(t, s))


def true_divide(a, b):
    a, b = _tensors(a, b)
    if not _inexact(a.dtype) and not _inexact(b.dtype):
        dt = _float_dtype(a, b)
        a, b = a.to(dt), b.to(dt)
    return torch.div(a, b)


divide = true_divide


def power(a, b):
    if _is_t(a) and not _is_t(b):
        return torch.pow(_fixup_bool_int(a, b), b)
    if _is_t(b) and not _is_t(a):
        b = _fixup_bool_int(b, a)
        return torch.pow(_scalar(a, b), b)
    a, b = _tensors(a, b)
    return torch.pow(a, b)


def _tensor_binary(fn, floating=False):
    """Binary op over two tensors (a scalar made a 0-d tensor)."""
    def op(a, b):
        a, b = _tensors(a, b)
        if floating:
            dt = torch.promote_types(a.dtype, b.dtype)
            if not _inexact(dt):
                dt = _float_dtype(a, b)
            a, b = a.to(dt), b.to(dt)
        return fn(a, b)
    return op


maximum = _tensor_binary(torch.maximum)
minimum = _tensor_binary(torch.minimum)
fmax = _tensor_binary(torch.fmax)
fmin = _tensor_binary(torch.fmin)
copysign = _tensor_binary(torch.copysign, floating=True)
hypot = _tensor_binary(torch.hypot, floating=True)
arctan2 = _tensor_binary(torch.atan2, floating=True)
gcd = _tensor_binary(torch.gcd)
lcm = _tensor_binary(torch.lcm)
logical_and = _tensor_binary(torch.logical_and)
logical_or = _tensor_binary(torch.logical_or)
logical_xor = _tensor_binary(torch.logical_xor)


def ldexp(x1, x2):
    x1, x2 = _tensors(x1, x2)
    return torch.ldexp(_to_float(x1), x2)


# -- reductions -------------------------------------------------------------------

def _reduce_all(x, axis, keepdims, fn):
    """``fn(x, dims, keepdim)`` over ``axis`` (None: every axis); a 0-d
    input or an empty axis tuple reduces nothing."""
    if x.ndim == 0 or axis == ():
        return fn(x, None, None)
    return fn(x, _axes(axis, x.ndim), keepdims)


def sum(a, axis=None, dtype=None, keepdims=False,  # noqa: A001
        initial=None):
    a = _t(a)
    dt = _acc_dtype(a, dtype)
    acc = torch.int64 if dt in _UINT_ACC else dt
    out = _reduce_all(a, axis, keepdims, lambda x, d, k: x.to(acc) if d is None
                      else torch.sum(x, dim=d, keepdim=k, dtype=acc))
    if initial is not None:
        out = out + initial
    return out.to(dt)


def nansum(a, axis=None, dtype=None, keepdims=False):
    a = _t(a)
    if _inexact(a.dtype):
        a = torch.where(torch.isnan(a), torch.zeros_like(a), a)
    return sum(a, axis, dtype, keepdims)


def prod(a, axis=None, dtype=None, keepdims=False):
    a = _t(a)
    dt = _acc_dtype(a, dtype)
    acc = torch.int64 if dt in _UINT_ACC else dt
    x = a.to(acc)
    if x.ndim == 0 or axis == ():
        return x.to(dt)
    for d in sorted(_axes(axis, x.ndim), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdims)
    return x.to(dt)


def nanprod(a, axis=None, dtype=None, keepdims=False):
    a = _t(a)
    if _inexact(a.dtype):
        a = torch.where(torch.isnan(a), torch.ones_like(a), a)
    return prod(a, axis, dtype, keepdims)


def mean(a, axis=None, dtype=None, keepdims=False):
    a = _t(a)
    dt = _mean_dtype(a, dtype)
    x = a.to(dt)
    if x.ndim == 0 or axis == ():
        return x
    return torch.mean(x, dim=_axes(axis, x.ndim), keepdim=keepdims)


def _moment(fn):
    def op(a, axis=None, dtype=None, ddof=0, keepdims=False):
        a = _t(a)
        x = a.to(_mean_dtype(a, dtype))
        if x.ndim == 0:
            return fn(x.reshape(1), dim=0, correction=ddof)
        return fn(x, dim=_axes(axis, x.ndim), correction=ddof,
                  keepdim=keepdims)
    return op


std = _moment(torch.std)
var = _moment(torch.var)


def _extreme(fn):
    def op(a, axis=None, keepdims=False):
        a = _t(a)
        x = a.to(torch.uint8) if a.dtype is torch.bool else a
        if x.ndim == 0 or axis == ():
            out = x
        else:
            out = fn(x, dim=_axes(axis, x.ndim), keepdim=keepdims)
        return out.to(a.dtype)
    return op


amax = max = _extreme(torch.amax)  # noqa: A001
amin = min = _extreme(torch.amin)  # noqa: A001


def _boolean(fn):
    def op(a, axis=None, keepdims=False):
        a = _t(a)
        if a.ndim == 0 or axis == ():
            return a.to(torch.bool)
        out = a.to(torch.bool)
        for d in sorted(_axes(axis, a.ndim), reverse=True):
            out = fn(out, dim=d, keepdim=keepdims)
        return out
    return op


all = _boolean(torch.all)  # noqa: A001
any = _boolean(torch.any)  # noqa: A001


def cumsum(a, axis=None, dtype=None):
    a = _t(a)
    dt = _acc_dtype(a, dtype)
    acc = torch.int64 if dt in _UINT_ACC else dt
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.cumsum(a.to(acc), dim=axis).to(dt)


def _arg(fn):
    def op(a, axis=None, keepdims=False):
        a = _t(a)
        x = a.to(torch.uint8) if a.dtype is torch.bool else a
        if axis is None:
            out = fn(x.reshape(-1), dim=0)
            if keepdims:
                out = out.reshape((1,) * a.ndim)
        else:
            out = fn(x, dim=axis, keepdim=keepdims)
        return out.to(_index_dtype(a))
    return op


argmax = _arg(torch.argmax)
argmin = _arg(torch.argmin)


def _sorted_along(a, axis):
    """(sorted values along the last axis, the moved axis) of ``a`` as
    float; ``axis`` None flattens."""
    x = _to_float(a)
    if axis is None:
        return torch.sort(x.reshape(-1)).values, None
    return torch.sort(x.movedim(axis, -1), dim=-1).values, axis


def _quantile_sorted(s, q, method):
    """Order-statistic interpolation along the last axis of sorted ``s``
    at fractions ``q`` (a Python float or a 0/1-d tensor), NumPy's
    methods."""
    n = s.shape[-1]
    qt = q if _is_t(q) else torch.tensor(q, dtype=torch.float64)
    pos = qt.to(torch.float64) * (n - 1)
    lo = torch.floor(pos)
    hi = torch.ceil(pos)
    frac = (pos - lo).to(s.dtype)
    if method == "lower":
        hi, frac = lo, torch.zeros_like(frac)
    elif method == "higher":
        lo, frac = hi, torch.zeros_like(frac)
    elif method == "nearest":
        lo = hi = torch.round(pos)
        frac = torch.zeros_like(frac)
    elif method == "midpoint":
        frac = torch.where(hi > lo, 0.5, 0.0).to(s.dtype)
    elif method != "linear":
        raise MXNetError(f"quantile method {method!r} is not supported")
    lo_i = lo.to(torch.int64).to(s.device)
    hi_i = hi.to(torch.int64).to(s.device)
    frac = frac.to(s.device)
    vlo = torch.index_select(s, -1, lo_i.reshape(-1))
    vhi = torch.index_select(s, -1, hi_i.reshape(-1))
    out = vlo + (vhi - vlo) * frac.reshape(-1)
    # q's axes lead, as in NumPy
    out = out.movedim(-1, 0).reshape(tuple(qt.shape) + s.shape[:-1])
    nan = torch.isnan(s).any(dim=-1)
    return torch.where(nan, torch.full_like(out, math.nan), out)


def quantile(a, q, axis=None, out=None, overwrite_input=False,
             method="linear", keepdims=False, interpolation=None):
    a = _t(a)
    method = interpolation or method
    s, ax = _sorted_along(a, axis)
    res = _quantile_sorted(s, q, method)
    if keepdims:
        qdims = res.ndim - (s.ndim - 1)
        if ax is None:
            res = res.reshape(res.shape[:qdims] + (1,) * a.ndim)
        else:
            res = res.unsqueeze(qdims + ax % a.ndim)
    return res


def percentile(a, q, axis=None, out=None, overwrite_input=False,
               method="linear", keepdims=False, interpolation=None):
    q = q / 100.0 if not _is_t(q) else q.to(torch.float64) / 100.0
    return quantile(a, q, axis, method=method, keepdims=keepdims,
                    interpolation=interpolation)


def median(a, axis=None, out=None, overwrite_input=False, keepdims=False):
    return quantile(a, 0.5, axis, keepdims=keepdims)


def average(a, axis=None, weights=None, returned=False, keepdims=False):
    a = _t(a)
    if weights is None:
        avg = mean(a, axis, keepdims=keepdims)
        wsum = torch.full_like(avg, a.numel() / builtins.max(avg.numel(), 1))
    else:
        w = weights if _is_t(weights) else _scalar(weights, a)
        dt = torch.promote_types(a.dtype, w.dtype)
        if not _inexact(dt):
            dt = _float_dtype(a, w)
        a, w = a.to(dt), w.to(dt)
        if w.shape != a.shape:
            if axis is None or w.ndim != 1:
                raise MXNetError("weights of another shape need an axis")
            shape = [1] * a.ndim
            shape[axis] = w.shape[0]
            w = w.reshape(shape)
        w = torch.broadcast_to(w, a.shape)
        dims = _axes(axis, a.ndim)
        wsum = torch.sum(w, dim=dims, keepdim=keepdims)
        avg = torch.sum(a * w, dim=dims, keepdim=keepdims) / wsum
    return (avg, wsum) if returned else avg


def trace(a, offset=0, axis1=0, axis2=1, dtype=None):
    d = torch.diagonal(_t(a), offset, axis1, axis2)
    return sum(d, axis=-1, dtype=dtype) if d.shape[-1] else \
        torch.zeros(d.shape[:-1], dtype=_acc_dtype(d, dtype),
                    device=d.device)


# -- shapes ---------------------------------------------------------------------

def reshape(a, newshape, order="C"):
    if order != "C":
        raise MXNetError("only order='C' is supported")
    if isinstance(newshape, int):
        newshape = (newshape,)
    return torch.reshape(_t(a), tuple(newshape))


def ravel(a, order="C"):
    return reshape(a, (-1,), order)


def transpose(a, axes=None):
    a = _t(a)
    if axes is None:
        return a.permute(tuple(reversed(range(a.ndim))))
    return a.permute(tuple(axes))


def swapaxes(a, axis1, axis2):
    return torch.swapaxes(_t(a), axis1, axis2)


def moveaxis(a, source, destination):
    return torch.movedim(_t(a), source, destination)


def rollaxis(a, axis, start=0):
    a = _t(a)
    n = a.ndim
    axis %= n
    start = start + n if start < 0 else start
    if axis < start:
        start -= 1
    if axis == start:
        return a
    return torch.movedim(a, axis, start)


def squeeze(a, axis=None):
    a = _t(a)
    if axis is None:
        return torch.squeeze(a)
    for d in sorted(_axes(axis, a.ndim), reverse=True):
        if a.shape[d] != 1:
            raise MXNetError(f"cannot squeeze axis {d} of size {a.shape[d]}")
        a = a.squeeze(d)
    return a


def expand_dims(a, axis):
    a = _t(a)
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    n = a.ndim + len(axes)
    for d in sorted(x % n for x in axes):
        a = a.unsqueeze(d)
    return a


def broadcast_to(array, shape):
    if isinstance(shape, int):
        shape = (shape,)
    return torch.broadcast_to(_t(array), tuple(shape))


def repeat(a, repeats, axis=None):
    a = _t(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.repeat_interleave(a, repeats, dim=axis)


def tile(A, reps):
    reps = (reps,) if isinstance(reps, int) else tuple(reps)
    return torch.tile(_t(A), reps)


def flip(m, axis=None):
    m = _t(m)
    return torch.flip(m, _axes(axis, m.ndim))


def fliplr(m):
    return torch.flip(_t(m), (1,))


def flipud(m):
    return torch.flip(_t(m), (0,))


def rot90(m, k=1, axes=(0, 1)):
    return torch.rot90(_t(m), k, tuple(axes))


def roll(a, shift, axis=None):
    a = _t(a)
    if axis is None:
        return torch.roll(a.reshape(-1), shift).reshape(a.shape)
    return torch.roll(a, shift, axis)


def _promote_all(xs):
    xs = [_t(x) for x in xs]
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def concatenate(seq, axis=0, out=None, dtype=None):
    xs = _promote_all(seq)
    if dtype is not None:
        xs = [x.to(torch_dtype(dtype)) for x in xs]
    if axis is None:
        return torch.cat([x.reshape(-1) for x in xs])
    return torch.cat(xs, dim=axis)


concat = concatenate


def stack(arrays, axis=0, out=None):
    return torch.stack(_promote_all(arrays), dim=axis)


def atleast_1d(*arys):
    out = [_t(a).reshape(1) if _t(a).ndim == 0 else _t(a) for a in arys]
    return out[0] if len(out) == 1 else out


def atleast_2d(*arys):
    out = []
    for a in arys:
        a = _t(a)
        out.append(a.reshape(1, 1) if a.ndim == 0 else
                   a.unsqueeze(0) if a.ndim == 1 else a)
    return out[0] if len(out) == 1 else out


def atleast_3d(*arys):
    out = []
    for a in arys:
        a = _t(a)
        if a.ndim == 0:
            a = a.reshape(1, 1, 1)
        elif a.ndim == 1:
            a = a.reshape(1, -1, 1)
        elif a.ndim == 2:
            a = a.unsqueeze(-1)
        out.append(a)
    return out[0] if len(out) == 1 else out


def vstack(tup):
    return torch.cat(_promote_all([atleast_2d(x) for x in tup]), dim=0)


row_stack = vstack


def hstack(tup):
    xs = [atleast_1d(x) for x in tup]
    return torch.cat(_promote_all(xs), dim=0 if xs[0].ndim == 1 else 1)


def dstack(tup):
    return torch.cat(_promote_all([atleast_3d(x) for x in tup]), dim=2)


def column_stack(tup):
    xs = [_t(x) for x in tup]
    xs = [x.reshape(-1, 1) if x.ndim < 2 else x for x in xs]
    return torch.cat(_promote_all(xs), dim=1)


def _split_points(n, indices_or_sections, strict):
    if isinstance(indices_or_sections, int):
        k = indices_or_sections
        if strict and n % k:
            raise MXNetError("array split does not result in an equal "
                             "division")
        each, extra = divmod(n, k)
        sizes = [each + 1] * extra + [each] * (k - extra)
        return sizes
    pts = [int(i) for i in indices_or_sections]
    bounds = [0] + [builtins.min(builtins.max(p if p >= 0 else p + n, 0), n)
                    for p in pts] + [n]
    return [builtins.max(b - a, 0) for a, b in zip(bounds[:-1], bounds[1:])]


def _split(a, indices_or_sections, axis, strict):
    a = _t(a)
    sizes = _split_points(a.shape[axis], indices_or_sections, strict)
    pts = [0]
    for s in sizes:
        pts.append(pts[-1] + s)
    return [a.narrow(axis, lo, hi - lo) if hi >= lo else
            a.narrow(axis, lo, 0) for lo, hi in zip(pts[:-1], pts[1:])]


def split(ary, indices_or_sections, axis=0):
    return _split(ary, indices_or_sections, axis, True)


def array_split(ary, indices_or_sections, axis=0):
    return _split(ary, indices_or_sections, axis, False)


def hsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, 1 if _t(ary).ndim > 1 else 0)


def vsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, 0)


def dsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, 2)


def append(arr, values, axis=None):
    arr, values = _t(arr), _t(values)
    if axis is None:
        return concatenate([arr.reshape(-1), values.reshape(-1)])
    return concatenate([arr, values], axis=axis)


def _index_list(obj, n):
    if _is_t(obj):
        obj = obj.tolist()
    if isinstance(obj, slice):
        return list(range(n))[obj]
    if isinstance(obj, int):
        obj = [obj]
    return [i + n if i < 0 else i for i in obj]


def delete(arr, obj, axis=None):
    arr = _t(arr)
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    n = arr.shape[axis]
    drop = set(_index_list(obj, n))
    keep = [i for i in range(n) if i not in drop]
    return torch.index_select(arr, axis, torch.tensor(keep, dtype=torch.long,
                                                      device=arr.device))


def insert(arr, obj, values, axis=None):
    """``values`` inserted before index ``obj`` (one integer) along
    ``axis`` (None: of the flattened array)."""
    arr = _t(arr)
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    if not isinstance(obj, int):
        raise MXNetError("insert takes one integer position here")
    n = arr.shape[axis]
    pos = obj + n if obj < 0 else obj
    v = (values if _is_t(values) else _scalar(values, arr)).to(arr.dtype)
    if arr.ndim == 1:
        piece = v.reshape(-1)
    else:
        shape = list(arr.shape)
        shape[axis] = 1
        piece = torch.broadcast_to(
            v.unsqueeze(axis) if v.ndim == arr.ndim - 1 else v, shape)
    return torch.cat([arr.narrow(axis, 0, pos), piece,
                      arr.narrow(axis, pos, n - pos)], dim=axis)


def resize(a, new_shape):
    a = _t(a)
    new_shape = (new_shape,) if isinstance(new_shape, int) \
        else tuple(new_shape)
    total = math.prod(new_shape)
    flat = a.reshape(-1)
    if flat.numel() == 0 or total == 0:
        return torch.zeros(new_shape, dtype=a.dtype, device=a.device)
    reps = -(-total // flat.numel())
    return flat.repeat(reps)[:total].reshape(new_shape)


def _pad_index(n, before, after, mode, device):
    """Source index of each output position along an axis of length
    ``n`` padded by (before, after), for the non-constant modes."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i.remainder(n)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        period = 2 * (n - 1)
        j = i.remainder(period)
        return torch.where(j >= n, period - j, j)
    if mode == "symmetric":
        period = 2 * n
        j = i.remainder(period)
        return torch.where(j >= n, period - 1 - j, j)
    raise MXNetError(f"pad mode {mode!r} is not supported")


def _pad_widths(pad_width, ndim):
    if isinstance(pad_width, int):
        return [(pad_width, pad_width)] * ndim
    pw = [tuple(p) if isinstance(p, (tuple, list)) else (p, p)
          for p in pad_width]
    if len(pw) == 1:
        pw = pw * ndim
    return [(int(a), int(b)) for a, b in pw]


def pad(array, pad_width, mode="constant", constant_values=0, **kwargs):
    x = _t(array)
    widths = _pad_widths(pad_width, x.ndim)
    if mode == "constant":
        flat = [p for a, b in reversed(widths) for p in (a, b)]
        if x.dtype is torch.bool:
            return torch.nn.functional.pad(
                x.to(torch.uint8), flat,
                value=float(constant_values)).to(torch.bool)
        return torch.nn.functional.pad(x, flat, value=constant_values)
    for axis, (before, after) in enumerate(widths):
        if before or after:
            idx = _pad_index(x.shape[axis], before, after, mode, x.device)
            x = torch.index_select(x, axis, idx)
    return x


# -- indexing and sorting -------------------------------------------------------

def argsort(a, axis=-1, kind=None, order=None):
    a = _t(a)
    x = a.to(torch.uint8) if a.dtype is torch.bool else a
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.argsort(x, dim=axis, stable=True).to(_index_dtype(a))


def sort(a, axis=-1, kind=None, order=None):
    a = _t(a)
    x = a.to(torch.uint8) if a.dtype is torch.bool else a
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.sort(x, dim=axis, stable=True).values.to(a.dtype)


def _fill_value(dt):
    if _inexact(dt):
        return math.nan
    if dt is torch.bool:
        return True
    info = torch.iinfo(dt)
    return info.min if info.min < 0 else info.max


def take_along_fill(a, idx, dim):
    """``jnp.take_along_axis(a, idx, dim)`` in its default mode: a
    negative index counts from the end, one still out of range gives
    :func:`_fill_value` (NaN for floats) and passes no gradient."""
    n = a.shape[dim]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    bad = (idx < 0) | (idx >= n)
    out = torch.take_along_dim(a, idx.clamp(0, builtins.max(n - 1, 0)),
                               dim=dim)
    return out.masked_fill(torch.broadcast_to(bad, out.shape),
                           _fill_value(a.dtype))


def take(a, indices, axis=None, mode=None, fill_value=None):
    a = _t(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    idx = indices if _is_t(indices) else torch.as_tensor(
        indices, device=a.device)
    idx = idx.to(torch.int64)
    n = a.shape[axis]
    if mode == "clip":
        safe = idx.clamp(0, builtins.max(n - 1, 0))
        bad = None
    elif mode == "wrap":
        safe, bad = idx.remainder(n), None
    else:
        safe = torch.where(idx < 0, idx + n, idx)
        bad = (safe < 0) | (safe >= n)
        safe = safe.clamp(0, builtins.max(n - 1, 0))
    out = torch.index_select(a, axis, safe.reshape(-1))
    out = out.reshape(a.shape[:axis] + tuple(idx.shape) + a.shape[axis + 1:])
    if bad is not None:
        shape = (1,) * axis + tuple(idx.shape) + (1,) * (a.ndim - axis - 1)
        fill = _fill_value(a.dtype) if fill_value is None else fill_value
        out = out.masked_fill(bad.reshape(shape), fill)
    return out


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)
    c = _t(condition)
    if not _is_t(x) and not _is_t(y):
        x, y = _tensors(x, y)
    elif not _is_t(x):
        x = _scalar(x, y)
    elif not _is_t(y):
        y = _scalar(y, x)
    return torch.where(c.to(torch.bool), x, y)


def nonzero(a):
    a = _t(a)
    if a.ndim == 0:
        a = a.reshape(1)
    idx = torch.nonzero(a, as_tuple=True)
    dt = _index_dtype(a)
    return tuple(i.to(dt) for i in idx)


def flatnonzero(a):
    a = _t(a)
    return torch.nonzero(a.reshape(-1)).reshape(-1).to(_index_dtype(a))


def unique(ar, return_index=False, return_inverse=False, return_counts=False,
           axis=None, equal_nan=True):
    ar = _t(ar)
    flat = ar.reshape(-1) if axis is None else ar
    values, inverse, counts = torch.unique(
        flat, sorted=True, return_inverse=True, return_counts=True,
        dim=axis)
    dt = _index_dtype(ar)
    out = [values]
    if return_index:
        n = flat.shape[0 if axis is None else axis]
        pos = torch.arange(n, device=ar.device)
        first = torch.full((values.shape[0 if axis is None else axis],), n,
                           dtype=torch.int64, device=ar.device)
        first = first.scatter_reduce(0, inverse.reshape(-1), pos,
                                     reduce="amin")
        out.append(first.to(dt))
    if return_inverse:
        inv = inverse.reshape(ar.shape) if axis is None else inverse
        out.append(inv.to(dt))
    if return_counts:
        out.append(counts.to(dt))
    return out[0] if len(out) == 1 else tuple(out)


def unravel_index(indices, shape):
    idx = _t(indices)
    dt = idx.dtype if not _inexact(idx.dtype) else torch.int32
    flat = idx.to(torch.int64)
    out = []
    for s in reversed(tuple(shape)):
        out.append(flat.remainder(s))
        flat = torch.div(flat, s, rounding_mode="floor")
    return tuple(o.to(dt) for o in reversed(out))


def diag(v, k=0):
    return torch.diag(_t(v), k)


def diagflat(v, k=0):
    return torch.diagflat(_t(v), k)


def diagonal(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(_t(a), offset, axis1, axis2)


def tril(m, k=0):
    return torch.tril(_t(m), k)


def triu(m, k=0):
    return torch.triu(_t(m), k)


def _tri_indices(fn, n, k, m, device):
    m = n if m is None else m
    idx = fn(n, m, k, device=device)
    return idx[0].to(torch.int32), idx[1].to(torch.int32)


def tril_indices(n, k=0, m=None, device=None):
    return _tri_indices(torch.tril_indices, n, k, m,
                        device or _default_device())


def triu_indices(n, k=0, m=None, device=None):
    return _tri_indices(torch.triu_indices, n, k, m,
                        device or _default_device())


def clip(a, a_min=None, a_max=None):
    a = _t(a)
    lo_hi = [v for v in (a_min, a_max) if v is not None]
    dt = a.dtype
    for v in lo_hi:
        dt = torch.promote_types(dt, v.dtype) if _is_t(v) else \
            torch.promote_types(dt, _weak(a, v))
    a = a.to(dt)
    if _is_t(a_min) or _is_t(a_max):
        lo = a_min.to(dt) if _is_t(a_min) else (
            None if a_min is None else _scalar(a_min, a, dt))
        hi = a_max.to(dt) if _is_t(a_max) else (
            None if a_max is None else _scalar(a_max, a, dt))
        return torch.clamp(a, lo, hi)
    return torch.clamp(a, a_min, a_max)


def diff(a, n=1, axis=-1, prepend=None, append=None):
    a = _t(a)

    def edge(v):
        """``prepend`` / ``append`` as a block along the axis (a scalar
        broadcast to one slice, as in NumPy)."""
        if v is None:
            return None
        v = v if _is_t(v) else _scalar(v, a)
        if v.ndim < a.ndim:
            shape = list(a.shape)
            shape[axis] = 1
            v = torch.broadcast_to(v.unsqueeze(axis) if v.ndim else v, shape)
        return v.to(a.dtype)
    return torch.diff(a, n=n, dim=axis, prepend=edge(prepend),
                      append=edge(append))


def ediff1d(ary, to_end=None, to_begin=None):
    a = _t(ary).reshape(-1)
    d = a[1:] - a[:-1]
    parts = []
    if to_begin is not None:
        parts.append(_t(to_begin).reshape(-1).to(d.dtype) if _is_t(to_begin)
                     else _scalar(to_begin, d, d.dtype).reshape(1))
    parts.append(d)
    if to_end is not None:
        parts.append(_t(to_end).reshape(-1).to(d.dtype) if _is_t(to_end)
                     else _scalar(to_end, d, d.dtype).reshape(1))
    return torch.cat(parts) if len(parts) > 1 else d


def bincount(x, weights=None, minlength=0, length=None):
    x = _t(x)
    n = length if length is not None else minlength
    if weights is None:
        out = torch.bincount(x.to(torch.int64), minlength=n)
        if length is not None:
            out = out[:length]
        return out.to(_index_dtype(x))
    w = weights if _is_t(weights) else _scalar(weights, x)
    out = torch.bincount(x.to(torch.int64), weights=w.to(torch.float64),
                         minlength=n)
    if length is not None:
        out = out[:length]
    return out.to(w.dtype if _inexact(w.dtype) else _float_dtype(w))


def histogram(a, bins=10, range=None, weights=None,  # noqa: A002
              density=None):
    """Counts (int64 unweighted, as the reference casts them) and the bin
    edges; the last bin holds its right edge, as in NumPy."""
    a = _to_float(_t(a)).reshape(-1)
    if _is_t(bins) or isinstance(bins, (list, tuple)):
        edges = _t(bins) if _is_t(bins) else torch.tensor(
            bins, dtype=a.dtype, device=a.device)
        edges = edges.to(a.dtype)
    else:
        if range is None:
            lo, hi = a.min(), a.max()
        else:
            lo, hi = (torch.tensor(float(r), dtype=a.dtype, device=a.device)
                      for r in range)
        hi = torch.where(hi == lo, hi + 0.5, hi)
        lo = torch.where(hi - 0.5 == lo, lo - 0.5, lo) if range is None \
            else lo
        steps = torch.arange(bins + 1, dtype=a.dtype, device=a.device)
        edges = lo + (hi - lo) * (steps / bins)
    nb = edges.numel() - 1
    idx = torch.searchsorted(edges, a, right=True) - 1
    idx = torch.where(a == edges[-1], nb - 1, idx)
    inside = (idx >= 0) & (idx < nb)
    safe = idx.clamp(0, nb - 1)
    w = weights.reshape(-1) if _is_t(weights) else None
    if w is None and not density:
        hist = torch.zeros(nb, dtype=torch.int64, device=a.device)
        hist = hist.index_add(0, safe, inside.to(torch.int64))
        return hist, edges
    wv = (w.to(a.dtype) if w is not None else torch.ones_like(a)) \
        * inside.to(a.dtype)
    hist = torch.zeros(nb, dtype=a.dtype, device=a.device).index_add(
        0, safe, wv)
    if density:
        hist = hist / (hist.sum() * (edges[1:] - edges[:-1]))
    return hist, edges


def interp(x, xp, fp, left=None, right=None, period=None):
    if period is not None:
        raise MXNetError("interp(period=) is not supported")
    x, xp, fp = _to_float(_t(x)), _to_float(_t(xp)), _to_float(_t(fp))
    dt = torch.promote_types(torch.promote_types(x.dtype, xp.dtype),
                             fp.dtype)
    x, xp, fp = x.to(dt), xp.to(dt), fp.to(dt)
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.numel() - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    dx = x1 - x0
    t = torch.where(dx == 0, torch.zeros_like(dx), (x - x0) / dx)
    out = f0 + t * (f1 - f0)
    lv = fp[0] if left is None else left
    rv = fp[-1] if right is None else right
    out = torch.where(x < xp[0], lv, out)
    return torch.where(x > xp[-1], rv, out)


def polyval(p, x):
    p, x = _t(p), _t(x)
    dt = torch.promote_types(p.dtype, x.dtype)
    if not _inexact(dt):
        dt = _float_dtype(p, x)
    p, x = p.to(dt), x.to(dt)
    y = torch.zeros_like(x)
    for i in builtins.range(p.shape[0]):
        y = y * x + p[i]
    return y


# -- linear algebra -------------------------------------------------------------

def _lin(a, b):
    a, b = _tensors(a, b)
    dt = torch.promote_types(a.dtype, b.dtype)
    if dt is torch.bool:
        dt = torch.int32
    return a.to(dt), b.to(dt)


def matmul(a, b):
    a, b = _lin(a, b)
    return torch.matmul(a, b)


def dot(a, b):
    a, b = _lin(a, b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if b.ndim == 1:
        return torch.tensordot(a, b, dims=([a.ndim - 1], [0]))
    return torch.tensordot(a, b, dims=([a.ndim - 1], [b.ndim - 2]))


def inner(a, b):
    a, b = _lin(a, b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.ndim - 1], [b.ndim - 1]))


def outer(a, b):
    a, b = _lin(a, b)
    return torch.outer(a.reshape(-1), b.reshape(-1))


def vdot(a, b):
    a, b = _lin(a, b)
    a = a.reshape(-1)
    return torch.dot(a.conj() if a.is_complex() else a, b.reshape(-1))


def kron(a, b):
    a, b = _lin(a, b)
    return torch.kron(a, b)


def cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    a, b = _lin(a, b)
    if axis is not None:
        axisa = axisb = axisc = axis
    a, b = a.movedim(axisa, -1), b.movedim(axisb, -1)
    if a.shape[-1] == 2 and b.shape[-1] == 2:
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    if a.shape[-1] == 2:
        a = torch.nn.functional.pad(a, (0, 1))
    if b.shape[-1] == 2:
        b = torch.nn.functional.pad(b, (0, 1))
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1).movedim(-1, axisc)


def tensordot(a, b, axes=2):
    a, b = _lin(a, b)
    if isinstance(axes, int):
        return torch.tensordot(a, b, dims=axes)
    ax_a, ax_b = axes
    ax_a = [ax_a] if isinstance(ax_a, int) else list(ax_a)
    ax_b = [ax_b] if isinstance(ax_b, int) else list(ax_b)
    return torch.tensordot(a, b, dims=(ax_a, ax_b))


def einsum(subscripts, *operands, optimize=False, **kwargs):
    xs = _promote_all(operands)
    return torch.einsum(subscripts, *xs)


# -- windows and creation -------------------------------------------------------

def _window(M, terms, device):
    if M <= 1:
        return torch.ones((builtins.max(M, 0),), dtype=torch.float32,
                          device=device)
    n = torch.arange(M, dtype=torch.float32, device=device)
    out = None
    for c, mult in terms:
        if mult == 0:
            term = torch.full((M,), c, dtype=torch.float32, device=device)
        else:
            term = c * torch.cos(mult * math.pi * n / (M - 1))
        out = term if out is None else out + term
    return out


def hanning(M, device=None):
    device = device or _default_device()
    if M <= 1:
        return _window(M, (), device)
    n = torch.arange(M, dtype=torch.float32, device=device)
    return 0.5 * (1 - torch.cos(2 * math.pi * n / (M - 1)))


def hamming(M, device=None):
    return _window(M, ((0.54, 0), (-0.46, 2)), device or _default_device())


def blackman(M, device=None):
    return _window(M, ((0.42, 0), (-0.5, 2), (0.08, 4)),
                   device or _default_device())


def tri(N, M=None, k=0, dtype=None, device=None):
    M = N if M is None else M
    dev = device or _default_device()
    i = torch.arange(N, device=dev).unsqueeze(1)
    j = torch.arange(M, device=dev).unsqueeze(0)
    return (j <= i + k).to(torch_dtype(dtype) or torch.float32)


def indices(dimensions, dtype=None, sparse=False, device=None):
    dev = device or _default_device()
    dt = torch_dtype(dtype) or torch.int32
    grids = torch.meshgrid(*[torch.arange(d, device=dev, dtype=dt)
                             for d in dimensions], indexing="ij")
    if sparse:
        return tuple(g[tuple(slice(None) if i == j else slice(0, 1)
                             for j in builtins.range(len(dimensions)))]
                     for i, g in enumerate(grids))
    if not grids:
        return torch.zeros((0,), dtype=dt, device=dev)
    return torch.stack(grids)


def fill_diagonal(a, val, wrap=False):
    """Functional, as the reference's (a copy with the diagonal set)."""
    a = _t(a)
    flat = a.clone().reshape(-1)
    if a.ndim == 2:
        step = a.shape[1] + 1
        end = flat.numel() if wrap else builtins.min(
            flat.numel(), a.shape[1] * a.shape[1])
    else:
        step = 1 + builtins.sum(math.prod(a.shape[:i])
                                for i in builtins.range(1, a.ndim))
        end = flat.numel()
    pos = torch.arange(0, end, step, device=a.device)
    if _is_t(val):
        v = val.to(a.dtype).reshape(-1)
        v = v.repeat(-(-pos.numel() // builtins.max(v.numel(), 1)))
        flat[pos] = v[:pos.numel()]
    else:
        flat[pos] = val
    return flat.reshape(a.shape)


def meshgrid(*xi, indexing="xy", sparse=False, copy=True):
    xs = [_t(x).reshape(-1) for x in xi]
    grids = torch.meshgrid(*xs, indexing=indexing)
    return list(grids)
