"""Flash attention: CUDA kernels written for Hopper, their plain PyTorch
versions, and the ``torch.autograd.Function`` that joins them.

Counterpart of ``mxnet_tpu/ops/pallas/flash_attention.py``: the forward
(``_fwd`` -> ``_fwd_kernel``) and the recompute backward (``_flash_bwd`` ->
``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``), joined by ``jax.custom_vjp``
there and by :class:`FlashAttentionFunction` here. The kernel sources are
``mxnet_tpu_torch/csrc/flash_attention_fwd.cu`` and
``flash_attention_bwd.cu``; their headers say what each replaces, what
bounds it on the H100 and what the design does about that.

:func:`flash_attention_fwd` takes contiguous ``(b*h, s, d)`` tensors and
returns ``(out, lse)`` with ``lse`` of shape ``(b*h, sq, 1)`` in float32,
as the TPU kernel does; :func:`flash_attention_bwd` takes the saved
``(q, k, v, out, lse)`` and the cotangent ``do`` and returns
``(dq, dk, dv)``. A CPU tensor takes the plain version
(:func:`flash_attention_fwd_reference`, :func:`flash_attention_bwd_reference`);
a CUDA tensor launches the kernels or raises. The TPU kernel's head_dim ->
128 lane padding, its block tables and its padded copies of ragged
sequences are not carried over.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _native
from .. import insight as _insight
from ..base import MXNetError

__all__ = ["flash_attention", "attention", "FlashAttentionFunction",
           "flash_attention_fwd", "flash_attention_fwd_reference",
           "flash_attention_bwd", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq", "flash_attention_bwd_reference",
           "HEAD_DIMS"]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the CUDA kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)
#: keys a tile of the forward's key walk where p is rounded to bf16: the
#: kernel's bf16 streamed tile. The reference accepts it as ``block_k``
#: but defaults to 128-1024 (512 on the CPU); rounded against those tiles'
#: running max, p differs, within 2^-7 of the output's largest value
#: (``test_bf16_plain_fwd_near_pallas_kernel_at_its_default_blocks``)
ROUND_TILE = 64


def _causal_valid(sq, sk, device):
    """(sq, sk) bool: key ``c`` is visible from query ``r`` when
    ``r >= c`` (top-left aligned, as the TPU kernels)."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    return rows >= cols


def _scale(d, scale):
    return 1.0 / (d ** 0.5) if scale is None else float(scale)


def _p_for_pv(s, m, p, valid, dtype):
    """p as the product with v takes it: the reference rounds p to the input
    dtype inside its key walk (``flash_attention.py:48-55``), against the
    running max of the keys seen so far. So p is rounded against the
    running max of the ``ROUND_TILE``-key tiles (the kernel's, not the
    reference's default), then brought to the final max ``m``. The
    identity in fp32."""
    if dtype == torch.float32:
        return p
    sk = s.shape[-1]
    n_tiles = -(-sk // ROUND_TILE)
    tiles = torch.nn.functional.pad(s, (0, n_tiles * ROUND_TILE - sk),
                                    value=_NEG_INF)
    tile_max = tiles.unflatten(-1, (n_tiles, ROUND_TILE)).amax(dim=-1)
    m_run = torch.cummax(tile_max, dim=-1).values.repeat_interleave(
        ROUND_TILE, dim=-1)[..., :sk]
    p_run = torch.exp(s - m_run)
    if valid is not None:
        p_run = torch.where(valid, p_run, 0.0)
    return p_run.to(dtype).float() * torch.exp(m_run - m)


def flash_attention_fwd_reference(q, k, v, causal=False, scale=None):
    """The kernel's function in plain PyTorch: fp32 scores, -1e30 masking
    (keys >= seq_k never exist here; ``q < k`` when causal, top-left
    aligned), fp32 softmax statistics, ``out = acc / max(l, 1e-30)`` in
    the input dtype and ``lse = m + log(max(l, 1e-30))``. As the reference
    (``flash_attention.py:52-55``), l sums the fp32 p and the product with
    v takes p rounded to the input dtype (:func:`_p_for_pv`)."""
    _, sq, d = q.shape
    sk = k.shape[1]
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * _scale(d, scale)
    valid = _causal_valid(sq, sk, q.device) if causal else None
    if causal:
        s = torch.where(valid, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(valid, p, 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.matmul(_p_for_pv(s, m, p, valid, v.dtype), v.float())
    return (pv / l_safe).to(q.dtype), m + torch.log(l_safe)


def _delta(out, do):
    """``rowsum(do * out)`` in fp32, (bh, sq, 1): the reference computes it
    outside its Pallas kernels too (``flash_attention.py:233``)."""
    return (do.float() * out.float()).sum(dim=-1, keepdim=True)


def _bwd_from_delta(q, k, v, do, lse, delta, causal, scale):
    """The two backward kernels' function in plain PyTorch, given delta:
    ``(dq, dk, dv)`` in the input dtype, with the reference's roundings
    (``p`` to ``do.dtype`` before dV, ``ds`` to ``q.dtype`` before dK and
    dQ; products of input-dtype values accumulated in fp32)."""
    _, sq, d = q.shape
    sk = k.shape[1]
    scale = _scale(d, scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(1, 2)) * scale
    if causal:
        valid = _causal_valid(sq, sk, q.device)
        s = torch.where(valid, s, _NEG_INF)
    p = torch.exp(s - lse)
    if causal:
        p = torch.where(valid, p, 0.0)
    dp = torch.matmul(dof, vf.transpose(1, 2))
    ds = p * (dp - delta) * scale
    dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2), dof)
    ds = ds.to(q.dtype).float()
    dk = torch.matmul(ds.transpose(1, 2), qf)
    dq = torch.matmul(ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, do, causal=False,
                                  scale=None):
    """The backward's function in plain PyTorch: ``(dq, dk, dv)`` of the
    attention ``out = flash_attention_fwd(q, k, v)`` for the cotangent
    ``do``, recomputed from ``lse`` as the TPU kernels do
    (``_bwd_block``)."""
    return _bwd_from_delta(q, k, v, do, lse, _delta(out, do), causal, scale)


def _bind(lib):
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def _bind_bwd(lib):
    for name, n_ptr in (("flash_attention_bwd_dkv", 8),
                        ("flash_attention_bwd_dq", 7)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p


def _check(q, k, v):
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise MXNetError("flash attention takes (b*h, s, d) tensors, "
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
        raise MXNetError("flash attention needs contiguous q, k, v")


def _check_bwd(q, k, v, do, **rows):
    """The backward's inputs: q/k/v as the forward's, ``do`` like ``q``,
    the per-row tensors (``lse``, ``delta``) fp32 (b*h, sq, 1), all
    contiguous on one device."""
    _check(q, k, v)
    row_shape = (q.shape[0], q.shape[1], 1)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise MXNetError(f"do must match q: {tuple(do.shape)} {do.dtype} vs "
                         f"{tuple(q.shape)} {q.dtype}")
    for name, t in rows.items():
        if tuple(t.shape) != row_shape or t.dtype != torch.float32:
            raise MXNetError(f"{name} must be float32 {row_shape}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if not all(t.device == q.device for t in (do, *rows.values())):
        raise MXNetError("flash attention backward: inputs on different "
                         "devices")
    if not all(t.is_contiguous() for t in (do, *rows.values())):
        raise MXNetError("flash attention backward needs contiguous inputs")


def _card(q, name):
    """Raise unless ``q`` lies where the CUDA kernels run (cuda:0) and its
    head_dim has an instantiation."""
    if q.device.type != "cuda":
        raise MXNetError(f"{name}: unsupported device {q.device}")
    if q.device.index not in (None, 0):
        # the kernel library launches on the thread's current device, 0
        raise MXNetError("the CUDA kernels run on cuda:0 only in this "
                         f"slice of the port, got {q.device}")
    if q.shape[2] not in HEAD_DIMS:
        raise MXNetError(f"head_dim {q.shape[2]} not supported by the CUDA "
                         f"kernel (supported: {HEAD_DIMS})")


def _aligned(*ts):
    """The kernels copy rows in 16-byte pieces: a tensor whose data does
    not start on 16 bytes (a view at an odd offset) is copied."""
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in ts]


def _launch(lib, name, err_fn, rc, q, k):
    if rc != 0:
        msg = getattr(lib, err_fn)(rc).decode()
        raise MXNetError(f"{name} launch failed: {msg} (code {rc}; "
                         f"bh={q.shape[0]} sq={q.shape[1]} sk={k.shape[1]} "
                         f"d={q.shape[2]} {q.dtype})")


def _pairs(sq, sk, causal):
    """Visible (q, k) pairs of one head (top-left causal)."""
    if not causal:
        return sq * sk
    if sq <= sk:
        return sq * (sq + 1) // 2
    return sk * (sk + 1) // 2 + (sq - sk) * sk


def _add_flops(per_pair, q, k, causal):
    """The kernel's FLOPs for a running ``insight.count`` (the aten ops'
    counter does not see a kernel launched through its C interface):
    ``per_pair`` x head_dim per visible pair and head, as PERF.md's bounds
    reckon them (forward 4, dK/dV 8, dQ 6)."""
    bh, sq, d = q.shape
    _insight.add_flops(per_pair * d * bh * _pairs(sq, k.shape[1], causal))


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """Attention forward on contiguous ``(b*h, s, d)``: ``(out, lse)``.

    CPU tensors go to :func:`flash_attention_fwd_reference`; CUDA tensors
    launch ``csrc/flash_attention_fwd.cu`` (built at first use) and count
    one launch in ``flash_attention_fwd.launches``."""
    _check(q, k, v)
    bh, sq, d = q.shape
    scale = _scale(d, scale)
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    _card(q, "flash_attention_fwd")
    lib = _native.load("flash_attention_fwd", _bind)
    q, k, v = _aligned(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, sq, k.shape[1], d, int(bool(causal)), scale,
        _DTYPE_CODES[q.dtype], stream)
    _launch(lib, "flash_attention_fwd", "flash_attention_error_string", rc,
            q, k)
    flash_attention_fwd.launches += 1
    if _insight._counting:
        _add_flops(4, q, k, causal)
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            scale=None):
    """``(dk, dv)`` of the attention backward, given ``delta``.

    CPU tensors take the plain version; CUDA tensors launch the dK/dV
    kernel of ``csrc/flash_attention_bwd.cu`` (replaces
    ``_bwd_dkv_kernel``) and count one launch in
    ``flash_attention_bwd_dkv.launches``."""
    _check_bwd(q, k, v, do, lse=lse, delta=delta)
    bh, sq, d = q.shape
    scale = _scale(d, scale)
    if q.device.type == "cpu":
        return _bwd_from_delta(q, k, v, do, lse, delta, causal, scale)[1:]
    _card(q, "flash_attention_bwd_dkv")
    lib = _native.load("flash_attention_bwd", _bind_bwd)
    q, k, v, do = _aligned(q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
        sq, k.shape[1], d, int(bool(causal)), scale, _DTYPE_CODES[q.dtype],
        stream)
    _launch(lib, "flash_attention_bwd_dkv",
            "flash_attention_bwd_error_string", rc, q, k)
    flash_attention_bwd_dkv.launches += 1
    if _insight._counting:
        _add_flops(8, q, k, causal)
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=False,
                           scale=None):
    """``dq`` of the attention backward, given ``delta``.

    CPU tensors take the plain version; CUDA tensors launch the dQ kernel
    of ``csrc/flash_attention_bwd.cu`` (replaces ``_bwd_dq_kernel``) and
    count one launch in ``flash_attention_bwd_dq.launches``."""
    _check_bwd(q, k, v, do, lse=lse, delta=delta)
    bh, sq, d = q.shape
    scale = _scale(d, scale)
    if q.device.type == "cpu":
        return _bwd_from_delta(q, k, v, do, lse, delta, causal, scale)[0]
    _card(q, "flash_attention_bwd_dq")
    lib = _native.load("flash_attention_bwd", _bind_bwd)
    q, k, v, do = _aligned(q, k, v, do)
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, sq, k.shape[1],
        d, int(bool(causal)), scale, _DTYPE_CODES[q.dtype], stream)
    _launch(lib, "flash_attention_bwd_dq",
            "flash_attention_bwd_error_string", rc, q, k)
    flash_attention_bwd_dq.launches += 1
    if _insight._counting:
        _add_flops(6, q, k, causal)
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, causal=False, scale=None):
    """Attention backward on contiguous ``(b*h, s, d)``: ``(dq, dk, dv)``
    for the cotangent ``do`` of ``out``. ``delta = rowsum(do * out)`` is one
    fp32 PyTorch reduction; then :func:`flash_attention_bwd_dkv` and
    :func:`flash_attention_bwd_dq`, which launch their kernel (CUDA) or
    take the plain version (CPU)."""
    if out.shape != q.shape or out.dtype != q.dtype:
        raise MXNetError(f"out must match q: {tuple(out.shape)} {out.dtype} "
                         f"vs {tuple(q.shape)} {q.dtype}")
    _check_bwd(q, k, v, do, lse=lse)
    delta = _delta(out, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention on contiguous ``(b*h, s, d)``: the
    forward kernel, and the two backward kernels as its backward (the
    reference's ``jax.custom_vjp`` ``_flash``). Saves ``(q, k, v, out,
    lse)``; the scores are rebuilt in the backward. The backward is
    first-order only (``autograd.grad(..., create_graph=True)`` refuses
    it)."""

    _first_order_only = True

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         do.to(q.dtype).contiguous(),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def attention(q, k, v, causal=False, scale=None):
    """Differentiable attention on contiguous ``(b*h, s, d)``: ``out`` of
    :func:`flash_attention_fwd`, with gradients through the backward
    kernels. Where autograd records nothing (under ``torch.no_grad()``, as
    in serving) the Function builds no graph and keeps no tensors."""
    return FlashAttentionFunction.apply(q, k, v, bool(causal),
                                        _scale(q.shape[-1], scale))


def flash_attention(q, k, v, causal=False, scale=None):
    """Multi-head attention on ``(batch, heads, seq, head_dim)``, the
    public layout of the JAX package's ``flash_attention``. Returns
    ``(batch, heads, seq_q, head_dim)``; differentiable in q, k and v."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out = attention(q.reshape(b * h, sq, d).contiguous(),
                    k.reshape(b * h, sk, d).contiguous(),
                    v.reshape(b * h, sk, d).contiguous(), causal, scale)
    return out.reshape(b, h, sq, d)
