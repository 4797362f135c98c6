"""Fused dropout + residual add + LayerNorm: CUDA kernels written for
Hopper, their plain PyTorch versions, and the ``torch.autograd.Function``
that joins them.

Counterpart of ``mxnet_tpu/ops/pallas/ln_residual.py``: the forward
(``_run_fwd`` -> ``_fwd_kernel``) and the backward (``_ln_residual_bwd``
-> ``_bwd_kernel``), joined by ``jax.custom_vjp`` there and by
:class:`LnResidualFunction` here. The kernel source is
``mxnet_tpu_torch/csrc/ln_residual.cu``; its header says what each kernel
replaces, what bounds it on the H100 (bytes) and what the design does
about that.

:func:`ln_residual_fwd` takes contiguous ``(n, D)`` rows ``x`` and ``h``,
the dropout keep mask (``None`` when ``p = 0``: then no mask is read at
all), ``gamma`` and ``beta`` ``(D,)``, and returns
``(LN(x + h*m*scale), mean, rstd)`` with ``scale = 1/(1-p)`` and the
statistics fp32 ``(n, 1)``. :func:`ln_residual_bwd` returns
``(dx, dh, dgamma, dbeta)``. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises. The TPU kernel's row padding to a
block multiple, its ones mask at ``p = 0`` and its 8-row dgamma/dbeta fold
are not carried over. The mask is an input, as in the reference: the
caller draws it (``random.dropout_mask``) and passes it in.

Dtypes follow the reference, which casts every input to fp32 inside its
kernel: rows x and h of fp32, bf16 or fp16 (each its own), gamma and beta
(one dtype) of any of those three, a mask of bool, uint8 or a float dtype
holding 0/1. ``out`` and ``dx`` come back in x's dtype, ``dh`` in h's,
``dgamma``/``dbeta`` in gamma's; all arithmetic is fp32. float64 (the
CPU's gradcheck) runs in float64 where x, h and gamma all are float64;
the CUDA kernels refuse it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _native
from ..base import MXNetError

__all__ = ["ln_residual_dropout", "LnResidualFunction", "ln_residual_fwd",
           "ln_residual_fwd_reference", "ln_residual_bwd",
           "ln_residual_bwd_reference", "MAX_DIM"]

#: the kernels' dtype codes (rows, gamma/beta)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the kernels' mask kinds (0: no mask, p = 0)
_MASK_KINDS = {torch.bool: 1, torch.uint8: 1, torch.float32: 2,
               torch.bfloat16: 3, torch.float16: 4}
_FLOATS = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
#: widest row the CUDA kernels take (32 values a thread, 256 threads)
MAX_DIM = 8192
_VEC_BYTES = 16
#: int32 counters a (device, stream) keeps for the backward's grid barrier
_TICKETS = 2


def _scale(p):
    return 1.0 / (1.0 - p) if p > 0 else 1.0


def _acc(dtype):
    """fp32 arithmetic, or fp64 for fp64 inputs (the CPU's gradcheck;
    ``_check`` lets float64 in only where x, h and gamma all are)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _residual(x, h, mask, p):
    """``s = x + h*m*scale`` in the arithmetic dtype, in the kernel's
    order; ``mask=None`` multiplies by 1."""
    acc = _acc(x.dtype)
    hm = h.to(acc) if mask is None else h.to(acc) * mask.to(acc)
    return x.to(acc) + hm * _scale(p)


def ln_residual_fwd_reference(x, h, mask, gamma, beta, p=0.0, eps=1e-5):
    """The forward kernel's function in plain PyTorch, step by step as the
    TPU kernel writes it: ``(out, mean, rstd)``, the statistics (n, 1) in
    fp32 (fp64 for fp64 inputs), ``out`` in x's dtype."""
    acc = _acc(x.dtype)
    s = _residual(x, h, mask, p)
    mean = s.mean(-1, keepdim=True)
    d = s - mean
    var = (d * d).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = d * rstd
    out = xhat * gamma.to(acc) + beta.to(acc)
    return out.to(x.dtype), mean, rstd


def ln_residual_bwd_reference(x, h, mask, gamma, mean, rstd, do, p=0.0):
    """The backward kernel's function in plain PyTorch: ``(dx, dh, dgamma,
    dbeta)`` of :func:`ln_residual_fwd_reference` for the cotangent
    ``do``, with s recomputed from ``(x, h, mask)`` as the TPU kernel
    does; dx in x's dtype, dh in h's, dgamma/dbeta in gamma's."""
    acc = _acc(x.dtype)
    s = _residual(x, h, mask, p)
    xhat = (s - mean) * rstd
    dof = do.to(acc)
    dxhat = dof * gamma.to(acc)
    ds = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dh = ds if mask is None else ds * mask.to(acc)
    dh = dh * _scale(p)
    return (ds.to(x.dtype), dh.to(h.dtype),
            (dof * xhat).sum(0).to(gamma.dtype), dof.sum(0).to(gamma.dtype))


def _bind(lib):
    lib.ln_residual_fwd.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.ln_residual_fwd.restype = ctypes.c_int
    lib.ln_residual_bwd_workspace.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.ln_residual_bwd_workspace.restype = ctypes.c_int
    lib.ln_residual_bwd.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.ln_residual_bwd.restype = ctypes.c_int
    lib.ln_residual_error_string.argtypes = [ctypes.c_int]
    lib.ln_residual_error_string.restype = ctypes.c_char_p


def _mask_of(x, mask, p):
    """The mask the kernels read: ``None`` at ``p = 0`` (as the reference,
    which then multiplies by ones), else a (n, D) tensor of bool, uint8 or
    a float dtype, holding 0/1."""
    if not 0.0 <= p < 1.0:
        raise MXNetError(f"dropout rate must be in [0, 1), got {p}")
    if p == 0:
        return None
    if mask is None:
        raise MXNetError("p > 0 requires a dropout keep-mask")
    if mask.shape != x.shape:
        raise MXNetError(f"mask {tuple(mask.shape)} must match x "
                         f"{tuple(x.shape)}")
    if mask.dtype not in (torch.bool, torch.uint8) + _FLOATS:
        raise MXNetError(f"mask dtype {mask.dtype} must be bool, uint8 or "
                         "a float dtype")
    return mask


def _check(x, h, mask, gamma, others=()):
    """Shapes, dtypes, devices and contiguity shared by both directions;
    ``others`` are further ``(name, tensor, shape, dtype)`` to hold."""
    if x.ndim != 2 or h.shape != x.shape or min(x.shape) <= 0:
        raise MXNetError(f"ln_residual takes (n, D) rows x and h of one "
                         f"shape, got {tuple(x.shape)}, {tuple(h.shape)}")
    dtypes = (x.dtype, h.dtype, gamma.dtype)
    if not all(d in _FLOATS for d in dtypes) or (
            torch.float64 in dtypes and set(dtypes) != {torch.float64}):
        raise MXNetError(f"x, h, gamma must each be float32, bfloat16 or "
                         f"float16 (or all float64), got {x.dtype}, "
                         f"{h.dtype}, {gamma.dtype}")
    if gamma.shape != (x.shape[1],):
        raise MXNetError(f"gamma {tuple(gamma.shape)} must be "
                         f"({x.shape[1]},)")
    tensors = [x, h, gamma] + ([] if mask is None else [mask])
    for name, t, shape, dtype in others:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise MXNetError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        tensors.append(t)
    if not all(t.device == x.device for t in tensors):
        raise MXNetError("ln_residual: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError("ln_residual needs contiguous inputs")


def _card(x, h, mask, gamma, name):
    """Raise unless the CUDA kernels take these inputs."""
    if x.device.type != "cuda":
        raise MXNetError(f"{name}: unsupported device {x.device}")
    if x.device.index not in (None, 0):
        raise MXNetError("the CUDA kernels run on cuda:0 only in this "
                         f"slice of the port, got {x.device}")
    for what, t in (("x", x), ("h", h), ("gamma", gamma)):
        if t.dtype not in _DTYPE_CODES:
            raise MXNetError(f"{name}: {what} dtype {t.dtype} is not "
                             "float32/bfloat16/float16")
    if mask is not None and mask.dtype not in _MASK_KINDS:
        raise MXNetError(f"{name}: mask dtype {mask.dtype} is not bool, "
                         "uint8, float32, bfloat16 or float16")
    if x.shape[1] > MAX_DIM:
        raise MXNetError(f"{name}: D={x.shape[1]} is above the kernels' "
                         f"maximum {MAX_DIM}")


def _rows(*rows):
    """The rows as the kernels take them, in one dtype: as they are where
    they share one, else each widened to fp32 (exact for bf16 and fp16),
    so that the kernel's results, rounded once to each output's dtype,
    are the values of the reference's fp32 arithmetic."""
    if len({t.dtype for t in rows}) == 1:
        return rows
    return tuple(t.float() for t in rows)


def _route(x, mask, packed):
    """(mask kind, 16-byte vector path) of one launch. The vector path
    moves 16 bytes' worth of x's values at once from each tensor in
    ``packed`` and the same count of values from the mask, so it needs D
    to be a multiple of that count and each pointer aligned to that many
    of its own elements."""
    per = _VEC_BYTES // x.element_size()
    kind = 0 if mask is None else _MASK_KINDS[mask.dtype]
    packed = packed + ([] if mask is None else [mask])
    vec = x.shape[1] % per == 0 and all(
        t.data_ptr() % (t.element_size() * per) == 0 for t in packed)
    return kind, int(vec)


def _launch_check(lib, name, rc, x):
    if rc != 0:
        msg = lib.ln_residual_error_string(rc).decode()
        raise MXNetError(f"{name} launch failed: {msg} (code {rc}; "
                         f"n={x.shape[0]} D={x.shape[1]} {x.dtype})")


def ln_residual_fwd(x, h, mask, gamma, beta, p=0.0, eps=1e-5):
    """``(LN(x + h*mask*scale), mean, rstd)`` of contiguous ``(n, D)``
    rows; ``out`` in x's dtype.

    CPU tensors go to :func:`ln_residual_fwd_reference`; CUDA tensors
    launch the forward kernel of ``csrc/ln_residual.cu`` (built at first
    use) and count one launch in ``ln_residual_fwd.launches``. Where x and
    h differ in dtype, both are widened to fp32 before the launch (exact)
    and ``out`` is rounded once to x's dtype afterwards: the reference's
    values, at the cost of those casts."""
    p = float(p)
    mask = _mask_of(x, mask, p)
    if beta.shape != gamma.shape or beta.dtype != gamma.dtype:
        raise MXNetError("beta must match gamma")
    _check(x, h, mask, gamma, [("beta", beta, tuple(gamma.shape),
                                gamma.dtype)])
    if x.device.type == "cpu":
        return ln_residual_fwd_reference(x, h, mask, gamma, beta, p, eps)
    _card(x, h, mask, gamma, "ln_residual_fwd")
    lib = _native.load("ln_residual", _bind)
    xr, hr = _rows(x, h)
    n, dim = x.shape
    out = torch.empty_like(xr)
    mean = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    kind, vec = _route(xr, mask, [xr, hr, gamma, beta, out])
    rc = lib.ln_residual_fwd(
        xr.data_ptr(), hr.data_ptr(), 0 if mask is None else mask.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), n, dim, _scale(p), float(eps),
        _DTYPE_CODES[xr.dtype], _DTYPE_CODES[gamma.dtype], kind, vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    _launch_check(lib, "ln_residual_fwd", rc, x)
    ln_residual_fwd.launches += 1
    return out.to(x.dtype), mean, rstd


ln_residual_fwd.launches = 0

_tickets = {}


def _tickets_for(device, stream):
    """The backward's int32 counters of one (device, stream), for the grid
    barrier before it sums dgamma/dbeta: a ticket count, which every
    launch leaves zero, and a generation word. Zeroed once, when first
    asked for, never per call."""
    key = (device.index or 0, stream)
    t = _tickets.get(key)
    if t is None:
        t = _tickets[key] = torch.zeros(_TICKETS, dtype=torch.int32,
                                        device=device)
    return t


@functools.lru_cache(maxsize=256)
def _workspace_floats(n, dim, dtype, kind, vec):
    """fp32 scratch floats (each block's row of dgamma/dbeta partials, 2 D
    a block) of one backward launch."""
    lib = _native.load("ln_residual", _bind)
    floats = ctypes.c_longlong()
    rc = lib.ln_residual_bwd_workspace(n, dim, dtype, kind, vec,
                                       ctypes.byref(floats))
    if rc != 0:
        raise MXNetError("ln_residual_bwd: no launch plan: "
                         f"{lib.ln_residual_error_string(rc).decode()} "
                         f"(n={n} D={dim})")
    return floats.value


def ln_residual_bwd(x, h, mask, gamma, mean, rstd, do, p=0.0):
    """``(dx, dh, dgamma, dbeta)`` for the cotangent ``do`` (x's dtype) of
    :func:`ln_residual_fwd`'s output, from its saved ``mean``/``rstd``:
    dx in x's dtype, dh in h's, dgamma/dbeta in gamma's.

    CPU tensors take :func:`ln_residual_bwd_reference`; CUDA tensors
    launch the backward kernel of ``csrc/ln_residual.cu`` once, which sums
    dgamma/dbeta itself in a fixed order (each block's fp32 partials in a
    scratch, a grid barrier on this stream's counters, then each block
    sums a slice of the columns, in gamma's dtype), and count one launch
    in ``ln_residual_bwd.launches``. Where x and h differ in dtype,
    x, h and do are widened to fp32 before the launch (exact) and dx and
    dh are rounded once to their dtypes afterwards."""
    p = float(p)
    mask = _mask_of(x, mask, p)
    n, dim = x.shape
    stat = torch.float64 if x.dtype == torch.float64 else torch.float32
    _check(x, h, mask, gamma, [
        ("mean", mean, (n, 1), stat), ("rstd", rstd, (n, 1), stat),
        ("do", do, (n, dim), x.dtype)])
    if x.device.type == "cpu":
        return ln_residual_bwd_reference(x, h, mask, gamma, mean, rstd, do,
                                         p)
    _card(x, h, mask, gamma, "ln_residual_bwd")
    lib = _native.load("ln_residual", _bind)
    xr, hr, dor = _rows(x, h, do)
    dx, dh = torch.empty_like(xr), torch.empty_like(hr)
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(gamma)
    kind, vec = _route(xr, mask, [xr, hr, dor, dx, dh])
    code = _DTYPE_CODES[xr.dtype]
    floats = _workspace_floats(n, dim, code, kind, vec)
    work = torch.empty(floats, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tickets = _tickets_for(x.device, stream)
    rc = lib.ln_residual_bwd(
        xr.data_ptr(), hr.data_ptr(), 0 if mask is None else mask.data_ptr(),
        gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dor.data_ptr(),
        dx.data_ptr(), dh.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
        work.data_ptr(), floats, tickets.data_ptr(), _TICKETS, n, dim,
        _scale(p), code, _DTYPE_CODES[gamma.dtype], kind, vec, stream)
    _launch_check(lib, "ln_residual_bwd", rc, x)
    ln_residual_bwd.launches += 1
    return dx.to(x.dtype), dh.to(h.dtype), dgamma, dbeta


ln_residual_bwd.launches = 0


class LnResidualFunction(torch.autograd.Function):
    """Differentiable ``LN(x + h*mask*scale)`` on contiguous ``(n, D)``
    rows: the forward kernel, and the backward kernel as its backward (the
    reference's ``jax.custom_vjp`` ``_ln_residual``). Saves ``(x, h, mask,
    gamma, mean, rstd)``; s is rebuilt in the backward. The mask gets no
    gradient. The backward is first-order only (``autograd.grad(...,
    create_graph=True)`` refuses it)."""

    _first_order_only = True

    @staticmethod
    def forward(ctx, x, h, mask, gamma, beta, p, eps):
        out, mean, rstd = ln_residual_fwd(x, h, mask, gamma, beta, p, eps)
        ctx.save_for_backward(x, h, mask if p > 0 else None, gamma, mean,
                              rstd)
        ctx.p = p
        return out

    @staticmethod
    def backward(ctx, do):
        x, h, mask, gamma, mean, rstd = ctx.saved_tensors
        dx, dh, dgamma, dbeta = ln_residual_bwd(
            x, h, mask, gamma, mean, rstd, do.to(x.dtype).contiguous(),
            ctx.p)
        return dx, dh, None, dgamma, dbeta, None, None


def ln_residual_dropout(x, h, gamma, beta, *, p=0.0, mask=None, eps=1e-5):
    """``LayerNorm(x + dropout(h))`` over the last axis in one pass.

    x, h: (..., D); gamma, beta: (D,). ``p``: the dropout rate applied to
    h; ``mask``: the keep mask (h's shape; bool, uint8 or any float dtype
    holding 0/1), required when ``p > 0`` and not read when ``p = 0``.
    Differentiable in x, h, gamma and beta."""
    shape = x.shape
    dim = shape[-1]
    p = float(p)
    if p > 0:
        if mask is None:
            raise ValueError("p > 0 requires a dropout keep-mask")
        mask = mask.reshape(-1, dim).contiguous()
    else:
        mask = None
    out = LnResidualFunction.apply(
        x.reshape(-1, dim).contiguous(), h.reshape(-1, dim).contiguous(),
        mask, gamma, beta, p, float(eps))
    return out.reshape(shape)
