"""``mx.np.ndarray``: the framework's array, over one ``torch.Tensor``.

Counterpart of ``mxnet_tpu/numpy/multiarray.py``, where an ``ndarray``
wraps one ``jax.Array``. Here it wraps one ``torch.Tensor`` (``__slots__``;
not a ``Tensor`` subclass: NumPy's ``size``, ``dtype`` and ``T`` differ
from torch's, and ``__torch_function__`` would tax every op of the port).

Every op goes through one :func:`_invoke` (reference: ``multiarray.py:151``):
it unwraps the arguments (an ``ndarray`` to its tensor; a host NumPy array
to a tensor on the operands' device), casts floating inputs by the AMP
policy under the op's name (``amp._op_cast_dtype``), calls the torch
function and wraps the result. Outside ``autograd.record()`` it runs under
``torch.no_grad()``, as blocks do, so only recorded computation can be
differentiated. It copies nothing from the host and never synchronizes for
tensor and Python-scalar arguments, so a hybridized forward written in
``mx.np`` captures into a CUDA graph. ``_invoke`` is the one place every op
passes: the host planes' hooks run there, in the reference's order (a
profiler ``"operator"`` span named by the op, the ``invoke.nan_output``
fault probe, the ``invoke.ops_total`` counter: ``_hooks.call``), behind one
module-attribute read (``_hooks.on``) while every plane is off.

Mutation rebinds, as in the reference: ``a[:] = v``, ``a += 1``,
``copyto`` and ``out=`` give the wrapper new storage and bump its
``version``, so no earlier result (a view of the old storage included)
ever sees a later write. An attached array (``attach_grad``) stays
attached across a rebind: its new storage becomes the leaf whose gradient
it reports. bf16 ``asnumpy()`` widens to float32 exactly (NumPy has no
bfloat16 without ``ml_dtypes``, which the port does not need);
``dtype`` is the port's ``bfloat16`` object. ``tostype`` converts to the
sparse storage types of ``ndarray.sparse``.
"""
from __future__ import annotations

import numpy as onp
import torch

from .. import _hooks, autograd
from ..base import (MXNetError, host_dtype, np_dtype, scalar_dtype,
                    torch_dtype)
from ..context import Context, resolve_device
from . import _ops

__all__ = ["ndarray", "array", "zeros", "ones", "empty", "full", "arange",
           "linspace", "logspace", "eye", "identity", "zeros_like",
           "ones_like", "full_like", "empty_like", "fromnumpy", "from_dlpack",
           "newaxis", "pi", "e", "inf", "nan", "euler_gamma"]

newaxis = None
pi = onp.pi
e = onp.e
inf = onp.inf
nan = onp.nan
euler_gamma = onp.euler_gamma

_amp = None  # ..amp, bound at the first op (amp imports the ops)


# -- wrapping --------------------------------------------------------------------

def _wrap(t):
    """An ``ndarray`` over tensor ``t`` (no copy)."""
    out = ndarray.__new__(ndarray)
    out._data = t
    out._grad = None
    out._var = None
    out._version = 0
    return out


def _wrap_out(out):
    """Wrap an op result: a tensor, or a tuple / list / NamedTuple of
    them."""
    if isinstance(out, torch.Tensor):
        return _wrap(out)
    if isinstance(out, tuple) and hasattr(out, "_fields"):
        return type(out)(*[_wrap_out(o) for o in out])
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap_out(o) for o in out)
    return out


def _unwrap_out(out):
    """The tensors of an ``ndarray`` result tree (``HybridBlock`` returns
    tensors to a tensor caller)."""
    if type(out) is ndarray:
        return out._data
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, tuple) and hasattr(out, "_fields"):
        return type(out)(*[_unwrap_out(o) for o in out])
    if isinstance(out, (tuple, list)):
        return type(out)(_unwrap_out(o) for o in out)
    if isinstance(out, dict):
        return {k: _unwrap_out(v) for k, v in out.items()}
    return out


def _host_tensor(obj, dtype=None, device=None, python=False):
    """A tensor of a host value (a NumPy array, a Python scalar or nested
    list) on ``device``, a copy, by the 32-bit rule: a host float64 array
    becomes float32 and its int64 stays int64, while Python ints give
    int32 (``python``: the value did not come as a NumPy array)."""
    host = onp.asarray(obj)
    if host.dtype.name == "bfloat16":  # an ml_dtypes array
        host = host.astype(onp.float32)
        dtype = dtype or torch.bfloat16
    if dtype is None:
        if host.dtype == onp.dtype("O"):
            raise MXNetError(f"cannot make an array of {type(obj).__name__}")
        dtype = host_dtype(host)
        if python and host.dtype.kind in "iu":
            dtype = torch.int32
    if dtype is torch.bfloat16:
        t = torch.tensor(host.astype(onp.float32), device=device)
        return t.to(torch.bfloat16)
    host = host.astype(np_dtype(dtype), copy=False)
    if any(st < 0 for st in host.strides):
        host = host.copy()   # torch takes no negative strides (a[:, ::-1])
    return torch.tensor(host, device=device)


def _tensor_device(args):
    for a in args:
        if type(a) is ndarray:
            return a._data.device
        if isinstance(a, torch.Tensor):
            return a.device
        if type(a) in (list, tuple):
            dev = _tensor_device(a)
            if dev is not None:
                return dev
    return None


def _unwrap(a, state):
    """``a`` with every ``ndarray`` replaced by its tensor and every host
    NumPy array by a tensor on the operands' device (``state``: [device,
    args])."""
    t = type(a)
    if t is ndarray:
        return a._data
    if t is list or t is tuple:
        return t(_unwrap(x, state) for x in a)
    if isinstance(a, onp.ndarray):
        if state[0] is None:
            state[0] = _tensor_device(state[1]) or resolve_device(None)
        return _host_tensor(a, device=state[0])
    if isinstance(a, onp.generic):
        return a.item()
    return a


def _cast(a, dt):
    if isinstance(a, torch.Tensor):
        if a.is_floating_point() and a.dtype != dt:
            return a.to(dt)
        return a
    if type(a) in (list, tuple):
        return type(a)(_cast(x, dt) for x in a)
    return a


def _invoke(prim, args, kwargs=None, name=None):
    """Dispatch one op: unwrap, the AMP policy by ``name``, the torch call
    (under ``torch.no_grad()`` unless ``autograd.record()`` records), wrap
    (reference: ``multiarray.py:151`` ``_invoke``), under the host planes'
    hooks while one is on."""
    if _hooks.on:
        return _hooks.call(_invoke_impl, name or getattr(
            prim, "__name__", "op"), (prim, args, kwargs, name), {},
            wrapped=True)
    return _invoke_impl(prim, args, kwargs, name)


def _invoke_impl(prim, args, kwargs, name):
    global _amp
    state = [None, args]
    args = [_unwrap(a, state) for a in args]
    if kwargs:
        kwargs = {k: _unwrap(v, state) for k, v in kwargs.items()}
    else:
        kwargs = {}
    if _amp is None:
        from .. import amp as _amp_mod
        _amp = _amp_mod
    if _amp.is_active():
        dt = _amp._op_cast_dtype(name or getattr(prim, "__name__", ""))
        if dt is not None:
            args = [_cast(a, dt) for a in args]
    if torch.is_grad_enabled() and not autograd.is_recording():
        with torch.no_grad():
            out = prim(*args, **kwargs)
    else:
        out = prim(*args, **kwargs)
    return _wrap_out(out)


def _writeback(out, res):
    """Write an op result through an ``out=`` destination (reference:
    ``multiarray.py:88``): the destination is rebound to the result cast
    to its dtype, so its aliases observe the update, and a recorded result
    keeps its graph."""
    if out is None:
        return res
    if isinstance(out, (tuple, list)):
        if not isinstance(res, (tuple, list)) or len(res) != len(out):
            raise ValueError("out= arity does not match op outputs")
        return type(out)(_writeback(o, r) for o, r in zip(out, res))
    if not isinstance(out, ndarray):
        raise TypeError(f"out= must be an mxnet ndarray, got {type(out)}")
    if not isinstance(res, ndarray):
        raise TypeError("op returned a non-array; cannot write through out=")
    if tuple(out.shape) != tuple(res.shape):
        raise ValueError(f"out= shape mismatch: destination {out.shape} vs "
                         f"result {res.shape}")
    out._data = res._data.to(device=out._data.device,
                             dtype=out._data.dtype)
    out._version += 1
    return out


# -- indexing keys ----------------------------------------------------------------

def _key_tensor(k, device):
    """An index key element as torch takes it: integer index tensors as
    int64, lists as tensors."""
    if type(k) is ndarray:
        k = k._data
    if isinstance(k, (list, onp.ndarray)):
        k = torch.as_tensor(onp.asarray(k), device=device)
    if isinstance(k, torch.Tensor):
        if k.dtype is not torch.bool and not k.is_floating_point():
            k = k.to(device=device, dtype=torch.int64)
        else:
            k = k.to(device)
    elif isinstance(k, onp.generic):
        k = k.item()
    return k


def _norm_key(key, t, for_set=False):
    """``key`` for torch: tensors moved and int64, and slices with a
    negative step resolved (torch has none): by a flip of the tensor for a
    read, by an index tensor for a write. Returns (tensor, key)."""
    items = list(key) if isinstance(key, tuple) else [key]
    items = [_key_tensor(k, t.device) for k in items]
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in items):
        return t, (tuple(items) if isinstance(key, tuple) else items[0])
    used = sum(k.ndim if isinstance(k, torch.Tensor) and
               k.dtype is torch.bool else 0 if k is None or k is Ellipsis
               else 1 for k in items)
    expanded = []
    for k in items:
        if k is Ellipsis:
            expanded.extend([slice(None)] * (t.ndim - used))
        else:
            expanded.append(k)
    dim = 0
    out = []
    for k in expanded:
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            n = t.shape[dim]
            picked = list(range(n))[k]
            if for_set:
                k = torch.tensor(picked, dtype=torch.int64, device=t.device)
            else:
                t = t.flip(dim)
                if picked:
                    k = slice(n - 1 - picked[0], n - picked[-1], -k.step)
                else:
                    k = slice(0, 0)
        out.append(k)
        if k is None:
            continue
        dim += k.ndim if isinstance(k, torch.Tensor) and \
            k.dtype is torch.bool else 1
    return t, tuple(out)


def _getitem(x, key):
    x, key = _norm_key(key, x)
    return x[key]


def _setitem(x, key, value):
    """A copy of ``x`` with ``x[key] = value`` (value in x's dtype)."""
    full = key is Ellipsis or (isinstance(key, slice) and key == slice(None))
    if isinstance(value, torch.Tensor):
        value = value.to(device=x.device, dtype=x.dtype)
    if full:
        v = value if isinstance(value, torch.Tensor) else torch.full(
            (), value, dtype=x.dtype, device=x.device)
        return torch.broadcast_to(v, x.shape).clone()
    new = x.clone()
    _, k = _norm_key(key, x, for_set=True)
    new[k] = value
    return new


# -- the fluent tail ---------------------------------------------------------------

# the reference's fluent-method list (``multiarray.py:374``), minus names
# implemented as real methods below; a name resolves where the port has
# the op (``mx.npx`` first, then ``mx.np``), else it is an AttributeError
_NDARRAY_FLUENT = frozenset("""
arccos arccosh arcsin arcsinh arctan arctanh argmax_channel
broadcast_axes broadcast_like cbrt ceil cos cosh degrees depth_to_space
diag expm1 fix flip floor log10 log1p log2 log_sigmoid log_softmax mish
nanprod nansum norm one_hot pad pick radians rcbrt reciprocal relu rint
rsqrt shape_array sigmoid sign sin sinh size_array slice_axis slice_like
softmax softmin space_to_depth split_v2 tan tanh tile topk trunc
""".split())
_FLUENT_CACHE: dict = {}


def _legacy_norm(data, ord=2, axis=None, keepdims=False):  # noqa: A002
    """The legacy fluent ``norm``: over every element unless ``axis``."""
    from . import linalg
    if axis is None:
        data = data.reshape(-1)
    return linalg.norm(data, ord=None if ord == 2 else ord, axis=axis,
                       keepdims=keepdims)


def _fluent(name):
    fn = _FLUENT_CACHE.get(name)
    if fn is None:
        from .. import numpy_extension as npx
        from .. import numpy as np_mod
        fn = _legacy_norm if name == "norm" else (
            getattr(npx, name, None) or np_mod._TABLE.get(name))
        if callable(fn):
            _FLUENT_CACHE[name] = fn
    return fn


# -- the array ------------------------------------------------------------------

def _ctx_of(device):
    if device.type == "cuda":
        return Context("gpu", device.index or 0)
    return Context("cpu", 0)


class ndarray:
    """N-dimensional array on a device (reference: numpy/multiarray.py
    ``ndarray``)."""

    __slots__ = ("_data", "_grad", "_var", "_version", "__weakref__")

    def __init__(self, data, ctx=None, dtype=None):
        src = array(data, dtype=dtype, ctx=ctx)
        self._data = src._data
        self._grad = None
        self._var = None
        self._version = 0

    # -- metadata ------------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def itemsize(self):
        return self._data.element_size()

    @property
    def nbytes(self):
        return self._data.numel() * self._data.element_size()

    @property
    def T(self):
        return _invoke(_ops.transpose, (self,), name="transpose")

    @property
    def ctx(self):
        """Context of this array (reference: ``NDArray.ctx``)."""
        return _ctx_of(self._data.device)

    context = ctx
    device = ctx

    @property
    def stype(self):
        return "default"

    # -- engine / version semantics -------------------------------------------
    @property
    def version(self):
        """Write-version counter (reference: ``NDArray::version``)."""
        return self._version

    def wait_to_read(self):
        """Block until the value is computed (``Engine::WaitForVar``)."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    def _rebind(self, t):
        """In-place value replacement: same wrapper, new storage,
        version + 1; an attached array stays attached (its new storage is
        the leaf its gradient comes from)."""
        var = self._var
        if var is not None and var.requires_grad:
            t = t.detach().requires_grad_(True)
            t.grad = var.grad
            t._mx_grad_req = var._mx_grad_req
            self._var = t
        self._data = t
        self._version += 1

    # -- conversion -------------------------------------------------------------
    def asnumpy(self):
        """Host copy, C-contiguous, writable and owned; bf16 widened to
        float32 exactly (NumPy has no bfloat16 without ``ml_dtypes``)."""
        t = self._data.detach()
        if t.dtype is torch.bfloat16:
            t = t.float()
        host = t.cpu().numpy()
        if t.device.type == "cpu" or not host.flags["C_CONTIGUOUS"]:
            host = onp.array(host, order="C", copy=True)
        return host

    def asscalar(self):
        return self.asnumpy().item()

    def item(self, *args):
        if args:
            return self.asnumpy().item(*args)
        return self._data.item()

    def tolist(self):
        return self.asnumpy().tolist()

    def astype(self, dtype, copy=True):
        dt = torch_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return _invoke(lambda x: x.to(dt), (self,), name="astype")

    def copy(self):
        return _invoke(torch.clone, (self,), name="copy")

    def copyto(self, other):
        """Copy the value into another array (rebound) or onto a context
        (reference: ``NDArray.copyto``)."""
        if isinstance(other, ndarray):
            if other.shape != self.shape:
                raise MXNetError(f"copyto shape mismatch {self.shape} vs "
                                 f"{other.shape}")
            other._rebind(self._data.detach().to(
                device=other._data.device, dtype=other._data.dtype,
                copy=True))
            return other
        if isinstance(other, (Context, torch.device, str)):
            return self.as_in_ctx(other)
        raise TypeError(type(other))

    def as_in_ctx(self, ctx):
        dev = resolve_device(ctx)
        if dev == self._data.device:
            return self
        return _wrap(self._data.detach().to(dev))

    as_in_context = as_in_ctx
    to_device = as_in_ctx

    def as_np_ndarray(self):
        return self

    def as_nd_ndarray(self):
        return self

    def tostype(self, stype):
        """This array in storage type ``stype``: "default" (itself),
        "row_sparse" or "csr" (``ndarray.sparse``; found on the host, as
        the reference's conversions are)."""
        if stype == "default":
            return self
        from ..ndarray import sparse
        if stype == "row_sparse":
            return sparse.row_sparse_array(self)
        if stype == "csr":
            return sparse.csr_matrix(self)
        raise MXNetError(f"unknown storage type {stype!r}")

    # -- NumPy interoperability protocols ----------------------------------------
    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__":
            return NotImplemented
        from .. import numpy as np_mod
        fn = np_mod._TABLE.get(ufunc.__name__)
        out = kwargs.pop("out", None)
        if out is not None:
            if isinstance(out, tuple):
                if len(out) != 1:
                    return NotImplemented
                out = out[0]
            kwargs["out"] = out
        if fn is None:
            return self._np_fallback(ufunc, inputs, kwargs)
        return fn(*inputs, **kwargs)

    def __array_function__(self, func, types, args, kwargs):
        from .. import numpy as np_mod
        fn = np_mod._TABLE.get(func.__name__)
        if fn is None:
            return self._np_fallback(func, args, kwargs)
        return fn(*args, **kwargs)

    @staticmethod
    def _np_fallback(func, args, kwargs):
        """Official NumPy on host copies, outside ``record()`` only
        (reference: ``multiarray.py:571``)."""
        if autograd.is_recording():
            raise MXNetError(
                f"falling back to official NumPy operator "
                f"{getattr(func, '__name__', func)} under autograd.record() "
                "is not supported (gradients cannot flow through host "
                "numpy); move the call outside the recording scope")

        def host(x):
            if isinstance(x, ndarray):
                return x.asnumpy()
            if type(x) in (list, tuple):
                return type(x)(host(v) for v in x)
            return x
        out = func(*host(tuple(args)), **{k: host(v) for k, v in
                                          kwargs.items()})
        return array(out) if isinstance(out, onp.ndarray) else out

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __dlpack__(self, stream=None):
        return self._data.detach().__dlpack__(stream=stream)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    # -- autograd ------------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """A zero gradient buffer, and this array a recording leaf
        (reference: ``NDArray.attach_grad`` over ``mark_variables``)."""
        autograd.mark_variables([self], [zeros_like(self)], grad_req)
        if self._var is not None:
            # known zeros: a row-sparse "add" replaces them (no host read)
            self._var.grad._mx_zeros = True

    def _mark_variable(self, grad, grad_req):
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be write, add or null, got "
                             f"{grad_req!r}")
        t = self._data.detach()
        if grad_req == "null":
            self._data, self._var, self._grad = t, None, None
            return
        if not (t.is_floating_point() or t.is_complex()):
            raise MXNetError(f"cannot attach a gradient to a {self.dtype} "
                             "array")
        t.requires_grad_(True)
        t._mx_grad_req = grad_req
        g = grad._data if isinstance(grad, ndarray) else grad
        t.grad = g.detach().to(device=t.device, dtype=t.dtype)
        self._data = self._var = t
        self._grad = grad if isinstance(grad, ndarray) else _wrap(t.grad)

    @property
    def _grad_req(self):
        return "null" if self._var is None else self._var._mx_grad_req

    @property
    def grad(self):
        """The gradient buffer (its wrapper rebound to the last written
        gradient); a row-sparse gradient (``npx.embedding(...,
        sparse_grad=True)``) as a ``RowSparseNDArray``."""
        if self._grad is None:
            return None
        g = self._var.grad
        if g is not None and g.is_sparse:
            from ..ndarray import sparse
            return sparse._cached_rsp(self._var)
        if g is not None and g is not self._grad._data:
            self._grad._data = g
            self._grad._version += 1
        return self._grad

    def zero_grad(self):
        if self._grad is None:
            return
        self._var.grad = torch.zeros_like(self._var)
        self._var.grad._mx_zeros = True
        self._grad._data = self._var.grad
        self._grad._version += 1

    def detach(self):
        return _wrap(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph, train_mode)

    # -- indexing --------------------------------------------------------------------
    def __getitem__(self, key):
        return _invoke(_getitem, (self, key), name="getitem")

    def __setitem__(self, key, value):
        if isinstance(value, (list, tuple)):
            value = onp.asarray(value)
        new = _invoke(_setitem, (self, key, value), name="setitem")._data
        if new.requires_grad:
            # a recorded functional set: the graph runs through it, as the
            # reference's entry moves to the set's result
            self._data = new
            self._version += 1
        else:
            self._rebind(new)

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of 0-d array")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __contains__(self, x):
        return bool((self == x).any())

    # -- Python scalar protocol ------------------------------------------------------
    def _scalar(self):
        if self.size != 1:
            raise TypeError(f"only size-1 arrays convert to python scalars, "
                            f"got {self.shape}")
        return self._data.reshape(()).item()

    def __bool__(self):
        if self.size == 1:
            return bool(self._scalar())
        raise ValueError("The truth value of an array with more than one "
                         "element is ambiguous. Use a.any() or a.all()")

    def __float__(self):
        return float(self._scalar())

    def __int__(self):
        return int(self._scalar())

    def __index__(self):
        if self._data.is_floating_point():
            raise TypeError("only integer arrays convert to an index")
        return int(self._scalar())

    def __hash__(self):
        return id(self)

    def __reduce__(self):
        return (_rebuild, (self.asnumpy(), str(self.dtype)))

    def __repr__(self):
        body = onp.array2string(self.asnumpy(), separator=", ")
        dev = "" if self._data.device.type == "cpu" else f", ctx={self.ctx}"
        return f"array({body}, dtype={self.dtype}{dev})"

    # -- arithmetic --------------------------------------------------------------------
    def _binop(self, other, fn, name, reflexive=False):
        if isinstance(other, (list, tuple)):
            other = onp.asarray(other)
        args = (other, self) if reflexive else (self, other)
        return _invoke(fn, args, name=name)

    def __add__(self, o): return self._binop(o, _ops.add, "add")
    def __radd__(self, o): return self._binop(o, _ops.add, "add", True)
    def __sub__(self, o): return self._binop(o, _ops.subtract, "subtract")
    def __rsub__(self, o): return self._binop(o, _ops.subtract, "subtract",
                                              True)
    def __mul__(self, o): return self._binop(o, _ops.multiply, "multiply")
    def __rmul__(self, o): return self._binop(o, _ops.multiply, "multiply",
                                              True)
    def __truediv__(self, o): return self._binop(o, _ops.true_divide,
                                                 "true_divide")
    def __rtruediv__(self, o): return self._binop(o, _ops.true_divide,
                                                  "true_divide", True)
    def __floordiv__(self, o): return self._binop(o, _ops.floor_divide,
                                                  "floor_divide")
    def __rfloordiv__(self, o): return self._binop(o, _ops.floor_divide,
                                                   "floor_divide", True)
    def __mod__(self, o): return self._binop(o, _ops.mod, "mod")
    def __rmod__(self, o): return self._binop(o, _ops.mod, "mod", True)
    def __pow__(self, o): return self._binop(o, _ops.power, "power")
    def __rpow__(self, o): return self._binop(o, _ops.power, "power", True)
    def __matmul__(self, o): return self._binop(o, _ops.matmul, "matmul")
    def __rmatmul__(self, o): return self._binop(o, _ops.matmul, "matmul",
                                                 True)
    def __neg__(self): return _invoke(_ops.negative, (self,), name="negative")
    def __pos__(self): return self
    def __abs__(self): return _invoke(_ops.absolute, (self,), name="abs")
    def __invert__(self): return _invoke(_ops.invert, (self,), name="invert")
    def __and__(self, o): return self._binop(o, _ops.bitwise_and,
                                             "bitwise_and")
    def __rand__(self, o): return self._binop(o, _ops.bitwise_and,
                                              "bitwise_and", True)
    def __or__(self, o): return self._binop(o, _ops.bitwise_or, "bitwise_or")
    def __ror__(self, o): return self._binop(o, _ops.bitwise_or,
                                             "bitwise_or", True)
    def __xor__(self, o): return self._binop(o, _ops.bitwise_xor,
                                             "bitwise_xor")
    def __rxor__(self, o): return self._binop(o, _ops.bitwise_xor,
                                              "bitwise_xor", True)
    def __lshift__(self, o): return self._binop(o, _ops.left_shift,
                                                "left_shift")
    def __rshift__(self, o): return self._binop(o, _ops.right_shift,
                                                "right_shift")
    def __eq__(self, o): return self._binop(o, _ops.equal, "equal")
    def __ne__(self, o): return self._binop(o, _ops.not_equal, "not_equal")
    def __lt__(self, o): return self._binop(o, _ops.less, "less")
    def __le__(self, o): return self._binop(o, _ops.less_equal, "less_equal")
    def __gt__(self, o): return self._binop(o, _ops.greater, "greater")
    def __ge__(self, o): return self._binop(o, _ops.greater_equal,
                                            "greater_equal")

    # in place: rebind the same wrapper (MXNet mutation semantics; the
    # result, recorded or not, becomes the array's value, reference _iop)
    def _iop(self, other, fn, name):
        res = self._binop(other, fn, name)
        self._data = res._data.to(self._data.dtype)
        self._version += 1
        return self

    def __iadd__(self, o): return self._iop(o, _ops.add, "add")
    def __isub__(self, o): return self._iop(o, _ops.subtract, "subtract")
    def __imul__(self, o): return self._iop(o, _ops.multiply, "multiply")
    def __itruediv__(self, o): return self._iop(o, _ops.true_divide,
                                                "true_divide")
    def __ifloordiv__(self, o): return self._iop(o, _ops.floor_divide,
                                                 "floor_divide")
    def __imod__(self, o): return self._iop(o, _ops.mod, "mod")
    def __ipow__(self, o): return self._iop(o, _ops.power, "power")

    # -- method forms of ops ------------------------------------------------------------
    def reshape(self, *shape, order="C"):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return _invoke(_ops.reshape, (self, tuple(int(s) for s in shape)),
                       name="reshape")

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _invoke(_ops.transpose, (self, axes or None),
                       name="transpose")

    def swapaxes(self, a1, a2):
        return _invoke(_ops.swapaxes, (self, a1, a2), name="swapaxes")

    def flatten(self, order="C"):
        return self.reshape(-1)

    ravel = flatten

    def squeeze(self, axis=None):
        return _invoke(_ops.squeeze, (self, axis), name="squeeze")

    def expand_dims(self, axis):
        return _invoke(_ops.expand_dims, (self, axis), name="expand_dims")

    def repeat(self, repeats, axis=None):
        return _invoke(_ops.repeat, (self, repeats, axis), name="repeat")

    def tile(self, reps):
        return _invoke(_ops.tile, (self, reps), name="tile")

    def broadcast_to(self, shape):
        return _invoke(_ops.broadcast_to, (self, shape), name="broadcast_to")

    def split(self, indices_or_sections, axis=0):
        return _invoke(_ops.split, (self, indices_or_sections, axis),
                       name="split")

    def take(self, indices, axis=None, mode="clip"):
        return _invoke(_ops.take, (self, indices, axis, mode), name="take")

    def clip(self, a_min=None, a_max=None):
        return _invoke(_ops.clip, (self, a_min, a_max), name="clip")

    def round(self, decimals=0):
        return _invoke(_ops.around, (self, decimals), name="round")

    def _reduce(self, fn, name, axis, keepdims, **kw):
        return _invoke(fn, (self,), dict(axis=axis, keepdims=keepdims, **kw),
                       name=name)

    def sum(self, axis=None, dtype=None, keepdims=False):
        return self._reduce(_ops.sum, "sum", axis, keepdims, dtype=dtype)

    def mean(self, axis=None, dtype=None, keepdims=False):
        return self._reduce(_ops.mean, "mean", axis, keepdims, dtype=dtype)

    def prod(self, axis=None, keepdims=False):
        return self._reduce(_ops.prod, "prod", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce(_ops.amax, "max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce(_ops.amin, "min", axis, keepdims)

    def std(self, axis=None, keepdims=False, ddof=0):
        return self._reduce(_ops.std, "std", axis, keepdims, ddof=ddof)

    def var(self, axis=None, keepdims=False, ddof=0):
        return self._reduce(_ops.var, "var", axis, keepdims, ddof=ddof)

    def all(self, axis=None, keepdims=False):
        return self._reduce(_ops.all, "all", axis, keepdims)

    def any(self, axis=None, keepdims=False):
        return self._reduce(_ops.any, "any", axis, keepdims)

    def argmax(self, axis=None):
        return _invoke(_ops.argmax, (self, axis), name="argmax")

    def argmin(self, axis=None):
        return _invoke(_ops.argmin, (self, axis), name="argmin")

    def argsort(self, axis=-1):
        return _invoke(_ops.argsort, (self, axis), name="argsort")

    def sort(self, axis=-1):
        return _invoke(_ops.sort, (self, axis), name="sort")

    def cumsum(self, axis=None, dtype=None):
        return _invoke(_ops.cumsum, (self, axis, dtype), name="cumsum")

    def dot(self, other):
        return self._binop(other, _ops.dot, "dot")

    def abs(self): return _invoke(_ops.absolute, (self,), name="abs")
    def exp(self): return _invoke(_ops.exp, (self,), name="exp")
    def log(self): return _invoke(_ops.log, (self,), name="log")
    def sqrt(self): return _invoke(_ops.sqrt, (self,), name="sqrt")
    def square(self): return _invoke(_ops.square, (self,), name="square")
    def sigmoid(self): return _invoke(_ops.sigmoid, (self,), name="sigmoid")
    def tanh(self): return _invoke(_ops.tanh, (self,), name="tanh")
    def relu(self): return _invoke(torch.relu, (self,), name="relu")

    def __getattr__(self, name):
        """The reference's legacy fluent op methods (``a.log_softmax()``,
        ``a.norm()``, ...), restricted to its fixed list; ``__slots__``
        means every other miss is a genuine AttributeError."""
        if name in _NDARRAY_FLUENT:
            fn = _fluent(name)
            if fn is not None:
                def method(*args, _fn=fn, **kwargs):
                    return _fn(self, *args, **kwargs)
                method.__name__ = name
                return method
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute {name!r}")


def _rebuild(host, dtype):
    return array(host, dtype=dtype)


# -- creation (reference: multiarray.py:983-1077) ------------------------------------

def _device(ctx, device):
    return resolve_device(device if device is not None else ctx)


def array(obj, dtype=None, ctx=None, device=None):
    """An array of ``obj`` on ``ctx`` / ``device`` (else the current
    context) by the 32-bit rule (``base.py``); a copy of host data."""
    dev = _device(ctx, device)
    dt = torch_dtype(dtype)
    if isinstance(obj, ndarray):
        obj = obj._data
    if isinstance(obj, torch.Tensor):
        t = obj.detach().to(device=dev, dtype=dt or obj.dtype)
        if t.data_ptr() == obj.data_ptr() and obj.numel():
            t = t.clone()
        return _wrap(t)
    return _wrap(_host_tensor(obj, dt, dev,
                              python=not isinstance(obj, (onp.ndarray,
                                                          onp.generic))))


def fromnumpy(a):
    return array(a)


def from_dlpack(x):
    """An array over anything that speaks DLPack (a capsule, a tensor, a
    NumPy array, ...), sharing its memory."""
    from torch.utils import dlpack
    return _wrap(dlpack.from_dlpack(x))


def _fill_dtype(value, dtype):
    if dtype is not None:
        return torch_dtype(dtype)
    if isinstance(value, (ndarray, torch.Tensor)):
        return getattr(value, "_data", value).dtype
    return scalar_dtype(value)


def empty(shape, dtype=None, ctx=None, device=None, order="C"):
    return zeros(shape, dtype, ctx, device)


def zeros(shape, dtype=None, ctx=None, device=None, order="C"):
    return _wrap(torch.zeros(shape, dtype=torch_dtype(dtype) or torch.float32,
                             device=_device(ctx, device)))


def ones(shape, dtype=None, ctx=None, device=None, order="C"):
    return _wrap(torch.ones(shape, dtype=torch_dtype(dtype) or torch.float32,
                            device=_device(ctx, device)))


def full(shape, fill_value, dtype=None, ctx=None, device=None, order="C"):
    dev = _device(ctx, device)
    dt = _fill_dtype(fill_value, dtype)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if isinstance(fill_value, (ndarray, torch.Tensor)):
        v = getattr(fill_value, "_data", fill_value).detach()
        return _wrap(torch.broadcast_to(v.to(device=dev, dtype=dt),
                                        shape).clone())
    return _wrap(torch.full(shape, fill_value, dtype=dt, device=dev))


def _like(fn, a, dtype):
    return _invoke(lambda x: fn(x, dtype=torch_dtype(dtype) or x.dtype),
                   (a,), name=fn.__name__)


def zeros_like(a, dtype=None, ctx=None, device=None):
    return _like(torch.zeros_like, a, dtype)


def ones_like(a, dtype=None, ctx=None, device=None):
    return _like(torch.ones_like, a, dtype)


def full_like(a, fill_value, dtype=None, ctx=None, device=None):
    return _invoke(lambda x: torch.full_like(
        x, fill_value, dtype=torch_dtype(dtype) or x.dtype), (a,),
        name="full_like")


def empty_like(a, dtype=None, ctx=None, device=None):
    return zeros_like(a, dtype, ctx, device)


def arange(start, stop=None, step=1, dtype=None, ctx=None, device=None):
    """Integers give int32 and any float float32, as the reference's."""
    if stop is None:
        start, stop = 0, start
    dev = _device(ctx, device)
    dt = torch_dtype(dtype) or (
        torch.float32 if any(isinstance(v, float) for v in (start, stop, step))
        else torch.int32)
    if dt.is_floating_point:
        n = max(int(onp.ceil((stop - start) / step)), 0)
        return _wrap(start + step * torch.arange(n, dtype=dt, device=dev))
    return _wrap(torch.arange(start, stop, step, dtype=dt, device=dev))


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, ctx=None, device=None):
    dev = _device(ctx, device)
    dt = torch_dtype(dtype) or torch.float32
    div = (num - 1) if endpoint else num
    if endpoint:
        out = torch.linspace(start, stop, num, dtype=torch.float32,
                             device=dev)
    else:
        out = torch.linspace(start, stop, num + 1, dtype=torch.float32,
                             device=dev)[:num]
    out = _wrap(out.to(dt))
    if retstep:
        return out, (stop - start) / div if div else float("nan")
    return out


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             axis=0, ctx=None, device=None):
    y = linspace(start, stop, num, endpoint, ctx=ctx, device=device)._data
    return _wrap(torch.pow(base, y).to(torch_dtype(dtype) or torch.float32))


def eye(N, M=None, k=0, dtype=None, ctx=None, device=None):
    dev = _device(ctx, device)
    M = N if M is None else M
    i = torch.arange(N, device=dev).unsqueeze(1)
    j = torch.arange(M, device=dev).unsqueeze(0)
    return _wrap((j - i == k).to(torch_dtype(dtype) or torch.float32))


def identity(n, dtype=None, ctx=None, device=None):
    return eye(n, dtype=dtype, ctx=ctx, device=device)
