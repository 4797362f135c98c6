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

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: widest row the CUDA kernels take (32 values a thread, 256 threads)
MAX_DIM = 8192
_VEC_BYTES = 16


def _scale(p):
    return 1.0 / (1.0 - p) if p > 0 else 1.0


def _acc(dtype):
    """fp32 arithmetic, or fp64 for fp64 inputs (the CPU's gradcheck)."""
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
    does."""
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
        ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.ln_residual_fwd.restype = ctypes.c_int
    lib.ln_residual_bwd.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.ln_residual_bwd.restype = ctypes.c_int
    lib.ln_residual_error_string.argtypes = [ctypes.c_int]
    lib.ln_residual_error_string.restype = ctypes.c_char_p


def _mask_of(x, mask, p):
    """The mask the kernels read: ``None`` at ``p = 0`` (as the reference,
    which then multiplies by ones), else a (n, D) tensor of x's dtype,
    bool or uint8."""
    if not 0.0 <= p < 1.0:
        raise MXNetError(f"dropout rate must be in [0, 1), got {p}")
    if p == 0:
        return None
    if mask is None:
        raise MXNetError("p > 0 requires a dropout keep-mask")
    if mask.shape != x.shape:
        raise MXNetError(f"mask {tuple(mask.shape)} must match x "
                         f"{tuple(x.shape)}")
    if mask.dtype not in (x.dtype, torch.bool, torch.uint8):
        raise MXNetError(f"mask dtype {mask.dtype} must be x's ({x.dtype}), "
                         "bool or uint8")
    return mask


def _check(x, h, mask, gamma, others=()):
    """Shapes, dtypes, devices and contiguity shared by both directions;
    ``others`` are further ``(name, tensor, shape, dtype)`` to hold."""
    if x.ndim != 2 or h.shape != x.shape or min(x.shape) <= 0:
        raise MXNetError(f"ln_residual takes (n, D) rows x and h of one "
                         f"shape, got {tuple(x.shape)}, {tuple(h.shape)}")
    if h.dtype != x.dtype or gamma.dtype != x.dtype:
        raise MXNetError(f"x, h, gamma must share one dtype, got {x.dtype}, "
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


def _card(x, name):
    """Raise unless the CUDA kernels take ``x``."""
    if x.device.type != "cuda":
        raise MXNetError(f"{name}: unsupported device {x.device}")
    if x.device.index not in (None, 0):
        raise MXNetError("the CUDA kernels run on cuda:0 only in this "
                         f"slice of the port, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise MXNetError(f"{name}: dtype {x.dtype} is not float32/bfloat16")
    if x.shape[1] > MAX_DIM:
        raise MXNetError(f"{name}: D={x.shape[1]} is above the kernels' "
                         f"maximum {MAX_DIM}")


def _route(x, mask, packed):
    """(mask kind, 16-byte vector path) of one launch. The vector path
    moves 16 bytes' worth of x's values at once from each tensor in
    ``packed`` and from the mask, so it needs D to be a multiple of that
    count and each pointer aligned to its pack (for a uint8 mask, that
    count of bytes)."""
    per = _VEC_BYTES // x.element_size()
    kind = 0 if mask is None else (1 if mask.dtype == x.dtype else 2)
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
    rows.

    CPU tensors go to :func:`ln_residual_fwd_reference`; CUDA tensors
    launch the forward kernel of ``csrc/ln_residual.cu`` (built at first
    use) and count one launch in ``ln_residual_fwd.launches``."""
    p = float(p)
    mask = _mask_of(x, mask, p)
    if beta.shape != gamma.shape or beta.dtype != gamma.dtype:
        raise MXNetError("beta must match gamma")
    _check(x, h, mask, gamma, [("beta", beta, tuple(gamma.shape),
                                gamma.dtype)])
    if x.device.type == "cpu":
        return ln_residual_fwd_reference(x, h, mask, gamma, beta, p, eps)
    _card(x, "ln_residual_fwd")
    lib = _native.load("ln_residual", _bind)
    n, dim = x.shape
    out = torch.empty_like(x)
    mean = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    kind, vec = _route(x, mask, [x, h, gamma, beta, out])
    rc = lib.ln_residual_fwd(
        x.data_ptr(), h.data_ptr(), 0 if mask is None else mask.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), n, dim, _scale(p), float(eps), _DTYPE_CODES[x.dtype],
        kind, vec, torch.cuda.current_stream(x.device).cuda_stream)
    _launch_check(lib, "ln_residual_fwd", rc, x)
    ln_residual_fwd.launches += 1
    return out, mean, rstd


ln_residual_fwd.launches = 0


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _rows_per_block(n, dim, device):
    """Rows each backward block walks: about two blocks per SM, each
    holding a (D,) row of dgamma/dbeta partials for the caller to sum."""
    groups = 4 if dim <= 1024 else 1  # rows a block works on at once
    return max(groups, -(-n // (2 * _sm_count(device.index or 0))))


def ln_residual_bwd(x, h, mask, gamma, mean, rstd, do, p=0.0):
    """``(dx, dh, dgamma, dbeta)`` for the cotangent ``do`` of
    :func:`ln_residual_fwd`'s output, from its saved ``mean``/``rstd``.

    CPU tensors take :func:`ln_residual_bwd_reference`; CUDA tensors
    launch the backward kernel of ``csrc/ln_residual.cu``, which writes one
    fp32 row of dgamma/dbeta partials per block, summed here with
    ``.sum(0)`` (as the reference sums its (8, D) partials outside its
    kernel), and count one launch in ``ln_residual_bwd.launches``."""
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
    _card(x, "ln_residual_bwd")
    lib = _native.load("ln_residual", _bind)
    rows = _rows_per_block(n, dim, x.device)
    blocks = -(-n // rows)
    dx, dh = torch.empty_like(x), torch.empty_like(h)
    dg_part = torch.empty((blocks, dim), dtype=torch.float32,
                          device=x.device)
    db_part = torch.empty_like(dg_part)
    kind, vec = _route(x, mask, [x, h, gamma, do, dx, dh])
    rc = lib.ln_residual_bwd(
        x.data_ptr(), h.data_ptr(), 0 if mask is None else mask.data_ptr(),
        gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(), do.data_ptr(),
        dx.data_ptr(), dh.data_ptr(), dg_part.data_ptr(), db_part.data_ptr(),
        n, dim, rows, _scale(p), _DTYPE_CODES[x.dtype], kind, vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    _launch_check(lib, "ln_residual_bwd", rc, x)
    ln_residual_bwd.launches += 1
    return (dx, dh, dg_part.sum(0).to(gamma.dtype),
            db_part.sum(0).to(gamma.dtype))


ln_residual_bwd.launches = 0


class LnResidualFunction(torch.autograd.Function):
    """Differentiable ``LN(x + h*mask*scale)`` on contiguous ``(n, D)``
    rows: the forward kernel, and the backward kernel as its backward (the
    reference's ``jax.custom_vjp`` ``_ln_residual``). Saves ``(x, h, mask,
    gamma, mean, rstd)``; s is rebuilt in the backward. The mask gets no
    gradient."""

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
    h; ``mask``: the keep mask (h's shape, 0/1 in h's dtype, or bool or
    uint8), required when ``p > 0`` and not read when ``p = 0``.
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
