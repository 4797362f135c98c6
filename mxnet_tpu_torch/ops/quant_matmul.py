"""Fused low-bit quantize + matmul + epilogue: the CUDA kernels written for
Hopper, their plain PyTorch versions, and the casts they share.

Counterpart of ``mxnet_tpu/ops/pallas/quant_matmul.py``: ``quantized_matmul``
-> ``_int8_kernel`` and ``fp8_matmul`` -> ``_fp8_kernel`` (with
``FP8_FORMATS`` and ``fp8_capable``). The kernel sources are
``mxnet_tpu_torch/csrc/int8_matmul.cu`` and ``csrc/fp8_matmul.cu``; their
headers say what each replaces, what bounds it on the H100 (bytes) and
what the design does about that.

Both compute ``act(dequant(quantize(x / x_scale) @ w_q.T) + bias)`` for x
``(M, K)`` fp32, ``w_q`` ``(N, K)`` (int8, or an fp8 dtype), ``w_scale``
``(N,)`` fp32 and a scalar ``x_scale``, and return ``(M, N)`` fp32; the
epilogue is ``acc * (x_scale * w_scale) + bias``, then the activation. A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The TPU kernels' block table (``autotune``) is not carried over:
the kernels take any M, N and K.

Both kernels run in two passes behind one call: a prepare pass that
quantizes x once into a scratch operand, then one persistent GEMM fed by
TMA (``csrc/lowbit_gemm.cuh``, shared by the two) that sums the products
in ``wgmma`` and applies the epilogue. fp8: x's and w's fp8 values are
widened to float16 (exact), padded with zero columns to K rounded up to 64,
as the reference pads w to 128 (:func:`fp8_operands_plain`), and summed in
the f16 ``wgmma`` with fp32 accumulators; the card's fp8 ``wgmma`` sums too
coarsely for the kernel's tolerance (``csrc/fp8_matmul.cu``). int8: x's
int8 values are padded with zero columns to K rounded up to 16 (w too
where K is not a multiple of 16; :func:`int8_operands_plain`) and summed
exactly in the s8 ``wgmma`` with int32 accumulators, so the kernel agrees
with its plain version bit for bit up to the activation. The wrappers
allocate the scratch operands.

The casts are the JAX package's. int8 (:func:`quantize_int8`):
``clip(round(v), -127, 127)`` with round half to even, NaN -> 0 and
+-inf -> +-127. fp8 (:func:`quantize`, ml_dtypes): round to nearest even,
and past the format's top NaN for e4m3fn and +-inf for e5m2, where
``Tensor.to()`` and the card's ``cvt.satfinite`` saturate. ``x / x_scale``
is a true division by a one-element tensor on x's device: torch's CUDA
division by a CPU scalar multiplies by its reciprocal instead.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _native
from ..base import MXNetError
from ..numpy_extension import _ACTS

__all__ = ["FP8_FORMATS", "fp8_capable", "quantize", "fp8_matmul",
           "fp8_matmul_plain", "fp8_operands_plain", "quantize_int8",
           "quantized_matmul", "quantized_matmul_plain",
           "int8_operands_plain"]

_INT8_MAX = 127.0
#: fp8 storage formats: name -> (dtype, absmax of the format)
FP8_FORMATS = {
    "e4m3": (torch.float8_e4m3fn, 448.0),
    "e5m2": (torch.float8_e5m2, 57344.0),
}
_FMT_CODES = {"e4m3": 0, "e5m2": 1}
_DTYPE_FMT = {dt: name for name, (dt, _) in FP8_FORMATS.items()}
_ACT_CODES = {None: 0, "relu": 1, "sigmoid": 2, "tanh": 3, "gelu": 4}


@functools.cache
def _capability(index):
    return torch.cuda.get_device_capability(index)


def _sm90(device):
    device = torch.device(device)
    return device.type == "cuda" and _capability(device.index or 0) == (9, 0)


def fp8_capable(device=None):
    """True for a CUDA device of compute capability 9.0, the target the
    kernels are built for (``sm_90a``); False on the CPU. ``None`` asks
    about ``cuda:0`` where CUDA is present."""
    if device is None:
        if not torch.cuda.is_available():
            return False
        device = torch.device("cuda", 0)
    return _sm90(device)


def _validate_act(act):
    if act not in _ACT_CODES:
        raise ValueError(f"unsupported fused activation {act!r}; one of "
                         f"{sorted(k for k in _ACT_CODES if k)}")


def _validate(fmt, act):
    if fmt not in FP8_FORMATS:
        raise ValueError(f"unknown fp8 format {fmt!r}; "
                         f"one of {sorted(FP8_FORMATS)}")
    _validate_act(act)


def quantize(v, fmt):
    """``v`` (float) cast to the fp8 format ``fmt`` by the JAX rule: round
    to nearest even; past the top (|v| > 464 for e4m3, whose tie at 464
    rounds down to 448; |v| >= 61440 for e5m2, whose tie rounds up) NaN in
    e4m3fn and +-inf in e5m2."""
    dt, _ = FP8_FORMATS[fmt]
    v = v.float()
    a = v.abs()
    if fmt == "e4m3":
        over, code = a > 464.0, torch.full_like(a, 0x7F, dtype=torch.uint8)
    else:
        over = a >= 61440.0
        code = torch.where(v < 0, 0xFC, 0x7C).to(torch.uint8)
    bits = torch.where(over, code, v.to(dt).view(torch.uint8))
    return bits.view(dt)


def _act(out, act):
    return out if act is None else _ACTS[act](out)


def _scale_tensor(x_scale, device):
    """x_scale as a 1-element fp32 tensor on ``device``."""
    if isinstance(x_scale, torch.Tensor):
        if x_scale.numel() != 1:
            raise MXNetError(f"x_scale must be a scalar, got shape "
                             f"{tuple(x_scale.shape)}")
        return x_scale.reshape(1).to(device=device, dtype=torch.float32)
    return torch.full((1,), float(x_scale), dtype=torch.float32,
                      device=device)


def fp8_matmul_plain(x, w_q, w_scale, x_scale, bias=None, act=None,
                     fmt="e4m3"):
    """The kernel's function in plain PyTorch, step by step as the TPU
    kernel writes it: quantize ``x / x_scale`` by the JAX cast rule, upcast
    both operands to fp32, ``x_q @ w_q.T`` in fp32, then ``acc * (x_scale
    * w_scale) + bias`` and the activation."""
    _validate(fmt, act)
    xs = _scale_tensor(x_scale, x.device)
    xq = quantize(x.float() / xs, fmt)
    acc = xq.float() @ w_q.float().t()
    out = acc * (xs * w_scale.float())
    if bias is not None:
        out = out + bias.float()
    return _act(out, act)


def _check(name, x, w_q, w_scale, bias, w_dtypes):
    if x.ndim != 2 or w_q.ndim != 2 or w_q.shape[1] != x.shape[1]:
        raise MXNetError(f"{name} takes x (M, K) and w_q (N, K), got "
                         f"{tuple(x.shape)}, {tuple(w_q.shape)}")
    if x.dtype != torch.float32:
        raise MXNetError(f"{name}: x must be float32, got {x.dtype}")
    if w_q.dtype not in w_dtypes:
        raise MXNetError(f"{name}: w_q must be "
                         f"{' or '.join(str(d)[6:] for d in w_dtypes)}, got "
                         f"{w_q.dtype}")
    n = w_q.shape[0]
    for what, t in (("w_scale", w_scale), ("bias", bias)):
        if t is not None and (tuple(t.shape) != (n,)
                              or t.dtype != torch.float32):
            raise MXNetError(f"{what} must be float32 ({n},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    tensors = [t for t in (x, w_q, w_scale, bias) if t is not None]
    if not all(t.device == x.device for t in tensors):
        raise MXNetError(f"{name}: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError(f"{name} needs contiguous inputs")


def _check_card(name, x, capable):
    """Raise unless x lies on ``cuda:0`` of a card the kernels are built
    for (``capable``)."""
    if x.device.type != "cuda":
        raise MXNetError(f"{name}: unsupported device {x.device}")
    if x.device.index not in (None, 0):
        raise MXNetError("the CUDA kernels run on cuda:0 only in this slice "
                         f"of the port, got {x.device}")
    if not capable:
        raise MXNetError(f"{name}: {torch.cuda.get_device_name(x.device)}"
                         " is not compute capability 9.0, which the kernel "
                         "is built for")


def _launch(lib, name, args, shape):
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = getattr(lib, name + "_error_string")(rc).decode()
        raise MXNetError(f"{name} launch failed: {msg} (code {rc}; {shape})")


def _bind(lib):
    lib.fp8_matmul.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    lib.fp8_matmul.restype = ctypes.c_int
    lib.fp8_matmul_error_string.argtypes = [ctypes.c_int]
    lib.fp8_matmul_error_string.restype = ctypes.c_char_p


#: values of K in one stage of the kernel's GEMM (64 f16, one 128-byte
#: swizzle row): its widened operands have rows of K rounded up to it
_K_TILE = 64


def _round_up(n, m):
    return (n + m - 1) // m * m


def fp8_operands_plain(x, w_q, x_scale, fmt="e4m3"):
    """The operands the kernel's GEMM reads, in plain PyTorch (what its
    prepare pass writes): ``quantize(x / x_scale, fmt)`` and ``w_q``, each
    widened to float16 (exact: float16 holds every e4m3fn and e5m2 value,
    NaN and inf included) and padded with zero columns to ``Kp``, K rounded
    up to the GEMM's k-tile of 64 values (a 128-byte row), so every row
    starts on 16 bytes. Zero adds nothing to the dot, as the reference's
    own padding of w (``_pad2``) adds nothing. Returns ``(xq (M, Kp),
    wq (N, Kp))``."""
    m, k = x.shape
    kp = _round_up(max(k, 1), _K_TILE)
    xq = x.new_zeros((m, kp), dtype=torch.float16)
    xq[:, :k] = quantize(x.float() / _scale_tensor(x_scale, x.device),
                         fmt).to(torch.float16)
    wq = x.new_zeros((w_q.shape[0], kp), dtype=torch.float16)
    wq[:, :k] = w_q.to(torch.float16)
    return xq, wq


def fp8_matmul(x, w_q, w_scale, x_scale, bias=None, act=None, fmt="e4m3"):
    """``act(dequant(fp8(x / x_scale) @ w_q.T) + bias)`` in one pass.

    x: (M, K) fp32; w_q: (N, K) float8_e4m3fn or float8_e5m2 (per output
    channel scaled); w_scale: (N,) fp32; x_scale: scalar (a number or a
    one-element tensor, read on the device); bias: (N,) fp32 or None; act:
    None, 'relu', 'sigmoid', 'tanh' or 'gelu' (tanh form); fmt: the
    activation's format, 'e4m3' or 'e5m2'. Returns (M, N) fp32.

    CPU tensors go to :func:`fp8_matmul_plain`; CUDA tensors launch the
    kernel of ``csrc/fp8_matmul.cu`` (built at first use) on a capable card
    (:func:`fp8_capable`) or raise, and count one launch in
    ``fp8_matmul.launches``."""
    _validate(fmt, act)
    _check("fp8_matmul", x, w_q, w_scale, bias, tuple(_DTYPE_FMT))
    if x.device.type == "cpu":
        return fp8_matmul_plain(x, w_q, w_scale, x_scale, bias, act, fmt)
    _check_card("fp8_matmul", x, fp8_capable(x.device))
    m, k = x.shape
    n = w_q.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    xs = _scale_tensor(x_scale, x.device)
    kp = _round_up(max(k, 1), _K_TILE)
    xq = torch.empty((m, kp), dtype=torch.float16, device=x.device)
    wq = torch.empty((n, kp), dtype=torch.float16, device=x.device)
    lib = _native.load("fp8_matmul", _bind)
    _launch(lib, "fp8_matmul", (
        x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), xs.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        xq.data_ptr(), wq.data_ptr(), m, n, k, kp, _FMT_CODES[fmt],
        _FMT_CODES[_DTYPE_FMT[w_q.dtype]], _ACT_CODES[act],
        torch.cuda.current_stream(x.device).cuda_stream),
        f"M={m} N={n} K={k} fmt={fmt}")
    fp8_matmul.launches += 1
    return out


fp8_matmul.launches = 0


# -- int8 (kernel 6) -----------------------------------------------------------

def quantize_int8(x, x_scale):
    """``x / x_scale`` to int8 by the JAX rule: round half to even, clip to
    +-127 (+-inf to +-127), NaN to 0 (the JAX cast's result on the CPU;
    torch's NaN -> int8 cast is undefined, so the 0 is written here)."""
    v = torch.round(x.float() / _scale_tensor(x_scale, x.device))
    q = v.clamp(-_INT8_MAX, _INT8_MAX)
    return torch.where(v.isnan(), 0.0, q).to(torch.int8)


def quantized_matmul_plain(x, w_q, w_scale, x_scale, bias=None, act=None):
    """The kernel's function in plain PyTorch, as the TPU kernel writes it:
    :func:`quantize_int8`, the int8 product summed exactly (as float64:
    every partial sum is an integer below 2^53, so this is the reference's
    int32 accumulation; torch has no integer matmul on CUDA) and rounded to
    fp32 once, then ``acc * (x_scale * w_scale) + bias`` and the
    activation."""
    _validate_act(act)
    xs = _scale_tensor(x_scale, x.device)
    xq = quantize_int8(x, xs)
    acc = xq.double() @ w_q.double().t()
    return _int8_epilogue(acc, xs, w_scale, bias, act)


def _int8_epilogue(acc, xs, w_scale, bias, act):
    """``act(float(acc) * (xs * w_scale) + bias)`` for an exact product
    ``acc`` (integers, any float dtype) and ``xs`` a one-element tensor:
    the kernel's epilogue, each operation rounded on its own."""
    out = acc.float() * (xs * w_scale.float())
    if bias is not None:
        out = out + bias.float()
    return _act(out, act)


#: the int8 kernel's operands have rows of K rounded up to this many
#: values, so that every row starts on TMA's 16-byte stride
_INT8_K_ALIGN = 16


def int8_operands_plain(x, w_q, x_scale):
    """The operands the int8 kernel's GEMM reads, in plain PyTorch (what its
    prepare pass writes): :func:`quantize_int8` of ``x / x_scale`` and
    ``w_q``, each padded with zero columns to ``Kp``, K rounded up to 16
    (at least 16), so every row starts on 16 bytes. Zero adds nothing to
    the exact sum, as the reference's own padding (``_pad2``) adds
    nothing. Returns ``(xq (M, Kp), wq (N, Kp))``, both int8."""
    m, k = x.shape
    kp = _round_up(max(k, 1), _INT8_K_ALIGN)
    xq = x.new_zeros((m, kp), dtype=torch.int8)
    xq[:, :k] = quantize_int8(x, x_scale)
    wq = w_q.new_zeros((w_q.shape[0], kp))
    wq[:, :k] = w_q
    return xq, wq


def _bind_int8(lib):
    lib.int8_matmul.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.int8_matmul.restype = ctypes.c_int
    lib.int8_matmul_error_string.argtypes = [ctypes.c_int]
    lib.int8_matmul_error_string.restype = ctypes.c_char_p


def quantized_matmul(x, w_q, w_scale, x_scale, bias=None, act=None):
    """``act(dequant(int8(x / x_scale) @ w_q.T) + bias)`` in one call.

    x: (M, K) fp32; w_q: (N, K) int8 (per output channel quantized);
    w_scale: (N,) fp32; x_scale: scalar (calibrated threshold / 127; a
    number or a one-element tensor, read on the device); bias: (N,) fp32
    or None; act: None, 'relu', 'sigmoid', 'tanh' or 'gelu' (tanh form).
    Returns (M, N) fp32.

    CPU tensors go to :func:`quantized_matmul_plain`; CUDA tensors launch
    the kernels of ``csrc/int8_matmul.cu`` (built at first use) on a card
    of compute capability 9.0 or raise, and count one launch in
    ``quantized_matmul.launches``. The wrapper allocates the s8 scratch of
    x (M, Kp), and of w (N, Kp) where K % 16 != 0 or w does not start on
    16 bytes (:func:`int8_operands_plain` is what they hold). The GEMM's
    output tile is 128 x 128 or 128 x 192, chosen by the kernel from the
    shape; ``quantized_matmul.tile_n`` = 128 or 192 forces one (0, the
    default, leaves the choice to the kernel), for measurement."""
    _validate_act(act)
    _check("quantized_matmul", x, w_q, w_scale, bias, (torch.int8,))
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, w_q, w_scale, x_scale, bias, act)
    _check_card("quantized_matmul", x, _sm90(x.device))
    m, k = x.shape
    n = w_q.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    xs = _scale_tensor(x_scale, x.device)
    kp = _round_up(max(k, 1), _INT8_K_ALIGN)
    xq = torch.empty((m, kp), dtype=torch.int8, device=x.device)
    wq = (None if kp == k and w_q.data_ptr() % 16 == 0 else
          torch.empty((n, kp), dtype=torch.int8, device=x.device))
    _int8_launch(x, w_q, w_scale, xs, bias, act, out, xq, wq)
    quantized_matmul.launches += 1
    return out


def _int8_launch(x, w_q, w_scale, xs, bias, act, out, xq, wq):
    """Launch the int8 kernels (prepare pass, then GEMM) into ``out`` with
    the s8 scratch ``xq`` (M, Kp) and ``wq`` (N, Kp) or None (the GEMM then
    reads ``w_q``); ``xs``: x_scale as a one-element tensor on the card."""
    m, k = x.shape
    n = w_q.shape[0]
    lib = _native.load("int8_matmul", _bind_int8)
    _launch(lib, "int8_matmul", (
        x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), xs.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        xq.data_ptr(), None if wq is None else wq.data_ptr(), m, n, k,
        xq.shape[1], _ACT_CODES[act], quantized_matmul.tile_n,
        torch.cuda.current_stream(x.device).cuda_stream),
        f"M={m} N={n} K={k}")


quantized_matmul.launches = 0
quantized_matmul.tile_n = 0
