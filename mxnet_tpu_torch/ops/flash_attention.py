"""Flash-attention forward: a CUDA kernel written for Hopper and its plain
PyTorch version.

Counterpart of ``mxnet_tpu/ops/pallas/flash_attention.py`` (the forward,
``_fwd`` -> ``_fwd_kernel``). The kernel source is
``mxnet_tpu_torch/csrc/flash_attention_fwd.cu``; its header says what it
replaces, what bounds it on the H100 and what the design does about that.

:func:`flash_attention_fwd` takes contiguous ``(b*h, s, d)`` tensors and
returns ``(out, lse)`` with ``lse`` of shape ``(b*h, sq, 1)`` in float32,
as the TPU kernel does. A CPU tensor takes the plain version
(:func:`flash_attention_fwd_reference`); a CUDA tensor launches the kernel
or raises. The TPU kernel's head_dim -> 128 lane padding and block tables
are not carried over.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _native
from ..base import MXNetError

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_reference", "HEAD_DIMS"]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the CUDA kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_fwd_reference(q, k, v, causal=False, scale=None):
    """The kernel's function in plain PyTorch: fp32 scores, -1e30 masking
    (keys >= seq_k never exist here; ``q < k`` when causal, top-left
    aligned), fp32 softmax statistics, ``out = acc / max(l, 1e-30)`` in
    the input dtype and ``lse = m + log(max(l, 1e-30))``."""
    _, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / (d ** 0.5) if scale is None else float(scale)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        valid = rows >= cols
        s = torch.where(valid, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(valid, p, 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = (torch.matmul(p, v.float()) / l_safe).to(q.dtype)
    return out, m + torch.log(l_safe)


def _bind(lib):
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def _check(q, k, v):
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise MXNetError("flash_attention_fwd takes (b*h, s, d) tensors, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise MXNetError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if min(q.shape[1], k.shape[1]) <= 0:
        raise MXNetError("empty sequence")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise MXNetError("q, k, v must share one dtype of float32/bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise MXNetError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise MXNetError("flash_attention_fwd needs contiguous q, k, v")


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """Attention forward on contiguous ``(b*h, s, d)``: ``(out, lse)``.

    CPU tensors go to :func:`flash_attention_fwd_reference`; CUDA tensors
    launch ``csrc/flash_attention_fwd.cu`` (built at first use) and count
    one launch in ``flash_attention_fwd.launches``."""
    _check(q, k, v)
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / (d ** 0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_attention_fwd: unsupported device "
                         f"{q.device}")
    if q.device.index not in (None, 0):
        # the kernel library launches on the thread's current device, 0
        raise MXNetError("the CUDA kernels run on cuda:0 only in this "
                         f"slice of the port, got {q.device}")
    if d not in HEAD_DIMS:
        raise MXNetError(f"head_dim {d} not supported by the CUDA kernel "
                         f"(supported: {HEAD_DIMS})")
    lib = _native.load("flash_attention_fwd", _bind)
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, sq, sk, d, int(bool(causal)), scale,
        _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise MXNetError(f"flash_attention_fwd launch failed: {msg} "
                         f"(code {rc}; bh={bh} sq={sq} sk={sk} d={d} "
                         f"{q.dtype})")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, causal=False, scale=None):
    """Multi-head attention on ``(batch, heads, seq, head_dim)``, the
    public layout of the JAX package's ``flash_attention``. Returns
    ``(batch, heads, seq_q, head_dim)``."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out, _ = flash_attention_fwd(
        q.reshape(b * h, sq, d).contiguous(),
        k.reshape(b * h, sk, d).contiguous(),
        v.reshape(b * h, sk, d).contiguous(), causal, scale)
    return out.reshape(b, h, sq, d)
