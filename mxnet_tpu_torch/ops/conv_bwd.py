"""Fused conv3x3 + BatchNorm + ReLU backward (kernel 8): the CUDA kernels
written for Hopper, their plain PyTorch version, and the
``torch.autograd.Function`` that joins them with the forward.

Counterpart of ``mxnet_tpu/ops/pallas_conv_bwd.py``:
``conv3x3_bn_relu_ref`` (the training forward), the stats pass and
``fused_conv3x3_bn_relu_bwd`` (-> ``_bwd_kernel``), ``fused_cbr_train``
(:class:`FusedCBRFunction` here) and ``eligible``. The kernel source is
``mxnet_tpu_torch/csrc/conv_bwd.cu``; its header says what it replaces,
what bounds it on the H100 (operations, at the 3xTF32 rate of the tensor
cores) and what the design does about that.

The layout is the port's NCHW throughout (x, da and y ``(N, C|O, H, W)``,
w OIHW ``(O, C, 3, 3)``), so the reference's NCHW <-> NHWC transposes
around the kernel have no counterpart. The backward is:

- the stats pass (:func:`bwd_stats`, plain PyTorch, as the reference's is
  XLA outside its kernel): ``xhat = (y - mean) * inv``, ``dz = where(gamma
  * xhat + beta > 0, da, 0)``, ``dbeta = sum dz``, ``dgamma = sum dz *
  xhat``, and the (8, O) fp32 vector ``[mean, inv, gamma, beta, dbeta/M,
  dgamma/M, gamma*inv, 0]`` with M = N*H*W;
- dy recomputed from ``(da, y, vec)`` as ``s1 * (dz - c1 - xhat * c2)``
  (never written to device memory by the kernels), then dgrad ``dx = sum_k
  shift_k(dy) @ wflip_k`` and wgrad ``dw_k = sum shift_k(x)^T @ dy`` over
  the 9 taps, summed to fp32 accuracy (3xTF32 on the tensor cores).

On the card one call is up to five launches on the caller's stream: the
weight split (w into its hi and lo TF32 parts, into scratch of ``(2, 9, C,
Opad)`` words, Opad = O rounded up to ``_CHUNK``), dgrad over tiles of
``_ROWS`` places of the padded grid x ``_COLS`` input channels, reducing
over chunks of ``_CHUNK`` output channels (cut into ``dgrad_splits`` runs
where the grid is thin or a run would pass ``_DG_RUN`` chunks, each run an
fp32 partial of dx summed by a reduce pass), and wgrad over tiles of
``_WG_TILE`` output x ``_WG_TILE`` input channels x 9 taps, reducing over
chunks of ``_PIXELS`` pixel slots (patches of one image, ``wgrad_patch``,
or consecutive pixels; cut into ``wgrad_splits`` runs of at most
``_WG_RUN`` chunks, each an fp32 partial of dw summed by a reduce pass).
The runs are bounded because the tensor core's fp32 accumulation is not
round-to-nearest: a run sums at most 32 x 27 (dgrad) or 32 x 24 (wgrad)
mma into one register, ~1e-5 of the largest value on the H100. Scratch
(split weights, partials) comes from ``torch.empty`` on the caller's
device; its element counts are within :func:`fits_card`'s 2^31.

bf16 (the reference at bf16, ``pallas_conv_bwd.py:61-95, 153-163``): dy
rounded to bf16 after its fp32 recompute, bf16 x bf16 products summed in
fp32, dx in bf16, dw summed in fp32 and stored in bf16; on the card the
kernels of the same file's bf16 instantiation (the weights copied once
into ``(9, C, Opad)`` bf16, Opad = O rounded up to ``_CHUNK_BF16``; dgrad's
chunks of ``_CHUNK_BF16`` output channels; one ``mma.sync`` m16n8k16 a
product). The plain version is the same function for every dtype: it
rounds dy to da's dtype and sums fp32 products of the operands' values.
The wrapper routes by dtype before any launch: x, da, y and w of one dtype
(float32 to the 3xTF32 kernels, bfloat16 to the bf16 ones on the card;
any floating dtype on the CPU), anything else raises.

The reference's VMEM budget (``fits_vmem``, 12 MiB, a TPU fact) is not
carried over; the card's limits are :func:`fits_card`'s, decided from
shape before any launch. A CPU tensor takes the plain version; a CUDA
tensor launches the kernels or raises.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _native
from .. import insight as _insight
from ..base import MXNetError

__all__ = ["conv3x3_bn_relu_ref", "bwd_stats", "fused_conv3x3_bn_relu_bwd",
           "fused_conv3x3_bn_relu_bwd_plain", "FusedCBRFunction",
           "eligible", "fits_card", "wgrad_splits", "dgrad_splits",
           "smem_bytes", "wgrad_patch"]

_ROWS = 128         # dgrad: places of the padded grid a block
_COLS = 64          # dgrad: input channels a block
_CHUNK = 8          # dgrad: output channels a reduction chunk
_CHUNK_BF16 = 16    # the same in the bf16 kernels (one k16 step)
_DG_RUN = 32        # dgrad: most chunks a split sums in its registers
_WG_TILE = 32       # wgrad: output and input channels a block (x 9 taps)
_PIXELS = 64        # wgrad: pixels a reduction chunk
_WG_RUN = 32        # wgrad: most chunks a split sums in its registers
_INT_MAX = 2 ** 31 - 1
_SMEM_MAX = 232448  # shared memory a block may use on an H100 (227 KB)


def _cdiv(a, b):
    return -(-a // b)


def _acc(t):
    """fp32 arithmetic, or fp64 for fp64 inputs (the CPU's gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _c(v):
    """A per-channel (O,) vector broadcast over NCHW."""
    return v.reshape(1, -1, 1, 1)


def _group(stats):
    """``stats``, or the identity group of each rank's own batch."""
    if stats is None:
        from ..parallel.collectives import StatsGroup
        return StatsGroup()
    return stats


def conv3x3_bn_relu_ref(x, w, gamma, beta, eps=1e-5, stats=None):
    """The training forward ``relu(bn(conv3x3_s1_same(x, w)))`` over batch
    statistics, two-pass (reference :167-178): ``(a, y, mean, var)``, y the
    conv output and mean/var fp32 (O,) (fp64 for fp64 inputs). Each pass's
    per-channel sums are summed over ``stats`` (a ``parallel.collectives.
    StatsGroup``; None: this rank's own batch) and divided by N*H*W times
    its ranks: with a group of several ranks, the global batch's
    statistics."""
    stats = _group(stats)
    acc = _acc(x)
    y = F.conv2d(x, w, padding=1)
    yf = y.to(acc)
    m = y.shape[0] * y.shape[2] * y.shape[3] * stats.size
    mean = stats.sum(yf.sum(dim=(0, 2, 3))) / m
    var = stats.sum(torch.square(yf - _c(mean)).sum(dim=(0, 2, 3))) / m
    inv = torch.rsqrt(var + eps)
    z = (yf - _c(mean)) * _c(inv) * _c(gamma.to(acc)) + _c(beta.to(acc))
    return F.relu(z).to(x.dtype), y, mean, var


def bwd_stats(da, y, gamma, beta, mean, var, eps=1e-5, stats=None):
    """The stats pass (reference :110-124): ``(dgamma, dbeta, vec)``, vec
    the (8, O) fp32 ``[mean, inv, gamma, beta, dbeta/M, dgamma/M,
    gamma*inv, 0]`` (fp64 for fp64 inputs). The kernel route and the plain
    version both take dgamma and dbeta from here. vec's dbeta/M and
    dgamma/M are the sums over ``stats`` (None: this rank's own batch)
    over its M, N*H*W times its ranks, which dgrad and wgrad then read;
    the returned dgamma and dbeta stay this rank's own (the dp reduce sums
    them)."""
    stats = _group(stats)
    acc = _acc(da)
    inv = torch.rsqrt(var.to(acc) + eps)
    mf, gf, bf = mean.to(acc), gamma.to(acc), beta.to(acc)
    xhat = (y.to(acc) - _c(mf)) * _c(inv)
    dz = torch.where(_c(gf) * xhat + _c(bf) > 0, da.to(acc), 0.0)
    dbeta = dz.sum(dim=(0, 2, 3))
    dgamma = (dz * xhat).sum(dim=(0, 2, 3))
    m = da.shape[0] * da.shape[2] * da.shape[3] * stats.size
    gb, gg = stats.sum(torch.stack([dbeta, dgamma]))
    vec = torch.stack([mf, inv, gf, bf, gb / m, gg / m, gf * inv,
                       torch.zeros_like(inv)])
    return dgamma.to(gamma.dtype), dbeta.to(beta.dtype), vec


def _dy(da, y, vec):
    """``s1 * (dz - c1 - xhat * c2)`` in da's dtype, each operation rounded
    on its own, as the kernel computes it."""
    mu, inv, gamma, beta, c1, c2, s1 = (_c(vec[i]) for i in range(7))
    xhat = (y.to(vec.dtype) - mu) * inv
    dz = torch.where(gamma * xhat + beta > 0, da.to(vec.dtype), 0.0)
    return (s1 * (dz - c1 - xhat * c2)).to(da.dtype)


def fused_conv3x3_bn_relu_bwd_plain(da, x, y, w, vec):
    """The kernel's function in plain PyTorch, step by step by its formula
    (not autograd of a conv): dy recomputed from ``(da, y, vec)``, dgrad as
    9 shifted products of the zero-padded dy with the flipped weights,
    wgrad as 9 products of the shifted zero-padded x with dy, each summed
    in fp32 (fp64 for fp64 inputs). Returns ``(dx, dw)`` in x's and w's
    dtypes."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    n, o, h, wd = da.shape
    dy = _dy(da, y, vec).to(acc)
    dyp = F.pad(dy, (1, 1, 1, 1))
    xp = F.pad(x.to(acc), (1, 1, 1, 1))
    wf = w.to(acc)
    dx = torch.zeros(x.shape, dtype=acc, device=x.device)
    dw = torch.zeros(w.shape, dtype=acc, device=x.device)
    for kh in range(3):
        for kw in range(3):
            # dgrad: dx += shift(dy) @ w[2-j, 2-l]^T, tap (j, l) = (2-kh, 2-kw)
            dsh = dyp[:, :, 2 - kh:2 - kh + h, 2 - kw:2 - kw + wd]
            dx += torch.einsum("nohw,oc->nchw", dsh, wf[:, :, kh, kw])
            # wgrad: dw_k = shift_k(x)^T @ dy
            xsh = xp[:, :, kh:kh + h, kw:kw + wd]
            dw[:, :, kh, kw] = torch.einsum("nchw,nohw->oc", xsh, dy)
    return dx.to(x.dtype), dw.to(w.dtype)


def _index(device):
    """The CUDA device index of ``device`` ('cuda' alone: the current)."""
    if device.index is not None or device.type != "cuda":
        return device.index or 0
    return torch.cuda.current_device()


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _linear_halo(h, w):
    """wgrad's x halo of a chunk of ``_PIXELS`` consecutive pixels, an
    upper bound: their places span at most 63 + (row breaks) + (image
    breaks)(W+1), and the taps reach W+2 places further on each side."""
    k = _PIXELS - 1
    return (k + min(k, k // w + 1) + min(k, k // (h * w) + 1) * (w + 1)
            + 2 * (w + 1) + 3)


def wgrad_patch(h, w):
    """``(rows, cols)`` of wgrad's chunk: a patch of one image where such
    patches tile it (rows | H, cols | W) with 56.._PIXELS pixels and an x
    halo, (rows+2) x (cols+2), smaller per pixel than a linear chunk's
    (8 x 8 at 56 x 56, 4 x 14 at 28 x 28); else ``(0, 0)``: ``_PIXELS``
    consecutive pixels. The kernel source chooses the same."""
    best = (0, 0)
    for pc in range(1, min(w, _PIXELS) + 1):
        if w % pc:
            continue
        pr = _PIXELS // pc
        while h % pr:
            pr -= 1
        area, halo = pr * pc, (pr + 2) * (pc + 2)
        if (area > best[0] * best[1] or (area == best[0] * best[1] and halo
                                         <= (best[0] + 2) * (best[1] + 2))):
            best = (pr, pc)
    pr, pc = best
    if (pr * pc < 56
            or (pr + 2) * (pc + 2) * _PIXELS >= _linear_halo(h, w) * pr * pc):
        return 0, 0
    return pr, pc


def wgrad_splits(n, h, w, c, o, sm_count):
    """``(splits, rows)`` of the wgrad kernel: its chunks (patches or runs
    of ``_PIXELS`` pixels, :func:`wgrad_patch`) are cut into ``splits`` runs
    of ``rows`` pixels (a whole number of chunks), about two blocks an SM
    over the (O, C) tiles (each with all 9 taps), no run under 256 pixels
    and none over ``_WG_RUN`` chunks: the tensor core's fp32 accumulation
    is not round-to-nearest, so the mma summed into one register are
    bounded (32 x 24). Each split writes its own fp32 partial of dw,
    summed in a fixed order, so equal inputs give equal bits."""
    m = n * h * w
    pr, pc = wgrad_patch(h, w)
    step = pr * pc or _PIXELS
    chunks = _cdiv(m, step)
    tiles = _cdiv(o, _WG_TILE) * _cdiv(c, _WG_TILE)
    want = max(1, min(_cdiv(m, 256), 2 * sm_count // tiles),
               _cdiv(chunks, _WG_RUN))
    cps = _cdiv(chunks, want)
    return _cdiv(chunks, cps), cps * step


def dgrad_splits(n, h, w, c, o, sm_count, chunk=_CHUNK):
    """``(dsplits, cps)`` of the dgrad kernel: its ceil(O / ``_CHUNK``)
    output-channel chunks (``_CHUNK_BF16`` in bf16) are cut into
    ``dsplits`` runs of ``cps`` chunks
    where the (places, C) tiles give fewer than about two blocks an SM
    (ResNet-50's 7 x 7 stage), and into runs of at most ``_DG_RUN`` chunks
    (the mma summed into one register are bounded: 32 x 27); each run
    writes its own fp32 partial of dx, summed in a fixed order."""
    tiles = (_cdiv(n * (h + 1) * (w + 1), _ROWS) * _cdiv(c, _COLS))
    chunks = _cdiv(o, chunk)
    want = max(1, min(chunks, 2 * sm_count // tiles),
               _cdiv(chunks, _DG_RUN))
    cps = _cdiv(chunks, want)
    return _cdiv(chunks, cps), cps


def smem_bytes(h, w, dtype=torch.float32):
    """``(dgrad, wgrad)`` shared memory a block, in bytes, at this H x W:
    dgrad's two-stage ring of 9 weight tiles and of the dy halo (``_ROWS``
    places and W+2 on each side, ``_CHUNK`` channels, hi and lo), wgrad's
    two-stage ring of the dy tile and the x halo (a chunk's places and
    their neighbours, ``_WG_TILE`` channels, hi and lo) with its tables.
    The kernel source computes the same (``conv3x3_bn_relu_bwd_smem``).
    bf16: one stage of 9 weight tiles of 16 channels (the fp32 tiles'
    bytes), the dy plane and no raw rows in dgrad; wgrad's bf16 dy tile
    and x halo with its tables (``conv3x3_bn_relu_bwd_bf16_smem``)."""
    halo = _ROWS + 2 * (w + 1) + 2
    pr, pc = wgrad_patch(h, w)
    if pr == 0:
        xh = _linear_halo(h, w)
    elif pr * pc < _PIXELS:  # two zero rows and 3 places for empty slots
        xh = (pr + 4) * (pc + 2) + 3
    else:
        xh = (pr + 2) * (pc + 2)
    if dtype == torch.bfloat16:
        dgrad = 4 * (2 * 9 * _COLS * _CHUNK + halo * _CHUNK
                     + 7 * _CHUNK_BF16 + halo)
        wgrad = (2 * (_WG_TILE * (_PIXELS + 8)
                      + _WG_TILE * (_cdiv(xh, 16) * 16 + 8))
                 + 4 * (2 * _PIXELS + xh + 1 + 7 * _WG_TILE))
        return dgrad, wgrad
    raw_ld = _cdiv(halo, 8) * 8 + 4
    dgrad = 4 * (4 * 9 * _COLS * _CHUNK + 2 * halo * _CHUNK
                 + 2 * raw_ld * _CHUNK + halo + 7 * _CHUNK)
    xs = _cdiv(xh, 8) * 8 + 4
    wgrad = 4 * (4 * _WG_TILE * (_PIXELS + 4) + 4 * _WG_TILE * xs
                 + 3 * (2 * _PIXELS + xh + 1) + 7 * _WG_TILE)
    return dgrad, wgrad


def fits_card(x, o):
    """Whether the CUDA kernels take input ``x`` (N, C, H, W, on a card)
    with O output channels: every tensor they index (x, da, y, dx, the
    split weights, the places of the padded grid, and the partials of dx
    and dw, split by the card's own SM count) below 2^31 elements, and both
    kernels' shared memory within the card's 227 KB a block (the x halo of
    wgrad's linear chunks grows with W: W up to 99 unless a patch tiles the
    image; the bf16 kernels need less of both). The fused route and the
    wrapper both decide by this."""
    n, c, h, w = x.shape
    if min(n, h, w, c, o) <= 0:
        return False
    sm = _sm_count(_index(x.device))
    splits, _ = wgrad_splits(n, h, w, c, o, sm)
    dsplits, _ = dgrad_splits(n, h, w, c, o, sm)
    elements = max(n * h * w * max(c, o), splits * o * 9 * c,
                   dsplits * n * c * h * w, 2 * 9 * c * _cdiv(o, _CHUNK)
                   * _CHUNK, (n + _PIXELS) * (h + 1) * (w + 1))
    return elements <= _INT_MAX and max(smem_bytes(h, w)) <= _SMEM_MAX


def eligible(kernel, strides, padding, dilation, groups, use_bias):
    """The shape class the kernel covers: 3x3, stride 1, SAME, dense, no
    bias (reference :213-217)."""
    return (tuple(kernel) == (3, 3) and tuple(strides) == (1, 1)
            and tuple(padding) == (1, 1) and tuple(dilation) == (1, 1)
            and groups == 1 and not use_bias)


def _bind(lib):
    lib.conv3x3_bn_relu_bwd.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.conv3x3_bn_relu_bwd.restype = ctypes.c_int
    lib.conv3x3_bn_relu_bwd_smem.argtypes = [ctypes.c_int, ctypes.c_int] + [
        ctypes.POINTER(ctypes.c_size_t)] * 2 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.conv3x3_bn_relu_bwd_smem.restype = None
    lib.conv3x3_bn_relu_bwd_bf16.argtypes = \
        lib.conv3x3_bn_relu_bwd.argtypes
    lib.conv3x3_bn_relu_bwd_bf16.restype = ctypes.c_int
    lib.conv3x3_bn_relu_bwd_bf16_smem.argtypes = [ctypes.c_int] * 2 + [
        ctypes.POINTER(ctypes.c_size_t)] * 2
    lib.conv3x3_bn_relu_bwd_bf16_smem.restype = None
    lib.conv3x3_bn_relu_bwd_error_string.argtypes = [ctypes.c_int]
    lib.conv3x3_bn_relu_bwd_error_string.restype = ctypes.c_char_p


def _check(da, x, y, w, gamma, beta, mean, var):
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[2:]) != (3, 3):
        raise MXNetError(f"conv3x3_bn_relu_bwd takes NCHW x and OIHW 3x3 w, "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    n, c, h, wd = x.shape
    o = w.shape[0]
    if w.shape[1] != c or da.shape != (n, o, h, wd) or y.shape != da.shape:
        raise MXNetError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, da {tuple(da.shape)}, y "
                         f"{tuple(y.shape)}")
    for name, t in (("gamma", gamma), ("beta", beta), ("mean", mean),
                    ("var", var)):
        if tuple(t.shape) != (o,):
            raise MXNetError(f"{name} must be ({o},), got {tuple(t.shape)}")
    if not all(t.device == x.device for t in (da, y, w, gamma, beta, mean,
                                              var)):
        raise MXNetError("conv3x3_bn_relu_bwd: inputs on different devices")
    if len({t.dtype for t in (x, da, y, w)}) != 1:
        raise MXNetError(f"conv3x3_bn_relu_bwd: x, da, y and w must share "
                         f"one dtype, got x {x.dtype}, da {da.dtype}, y "
                         f"{y.dtype}, w {w.dtype}")


def _card(x, da, y, w):
    """Raise unless the CUDA kernels take these tensors."""
    if x.device.type != "cuda":
        raise MXNetError(f"conv3x3_bn_relu_bwd: unsupported device "
                         f"{x.device}")
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise MXNetError(f"conv3x3_bn_relu_bwd: "
                         f"{torch.cuda.get_device_name(x.device)} is not "
                         "compute capability 9.0, which the kernel is built "
                         "for")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise MXNetError(f"conv3x3_bn_relu_bwd: the kernels take float32 "
                         f"or bfloat16, got {x.dtype}")
    if not fits_card(x, w.shape[0]):
        raise MXNetError(f"conv3x3_bn_relu_bwd: shape {tuple(x.shape)} x "
                         f"{tuple(w.shape)} is beyond the kernels' 2^31 "
                         "element indexing or shared memory")


def fused_conv3x3_bn_relu_bwd(da, x, y, w, gamma, beta, mean, var,
                              eps=1e-5, stats=None):
    """Backward of ``relu(bn_train(conv3x3_s1_same(x, w)))`` through batch
    statistics: ``(dx, dw, dgamma, dbeta)``.

    da, y: (N, O, H, W); x: (N, C, H, W); w: (O, C, 3, 3); gamma, beta,
    mean, var: (O,). dgamma and dbeta come from :func:`bwd_stats`. CPU
    tensors take :func:`fused_conv3x3_bn_relu_bwd_plain`; CUDA tensors
    (fp32 or bf16, on a card of compute capability 9.0) launch the
    kernels of ``csrc/conv_bwd.cu`` (built at first use) or raise, and
    count one call
    in ``fused_conv3x3_bn_relu_bwd.launches`` (a bf16 call also in
    ``.bf16_launches``), one under its ``(N, H, W, C, O)`` in
    ``.shape_launches`` and one launch of each CUDA kernel in
    ``.kernel_launches`` (the bf16 kernels under names ending in
    ``_bf16``). x, da, y and w share one dtype: float32 launches the
    3xTF32 kernels, bfloat16 the bf16 ones; the dtype routes before any
    launch, and a failed launch raises. ``stats``: global batch
    statistics (:func:`bwd_stats`)."""
    _check(da, x, y, w, gamma, beta, mean, var)
    dgamma, dbeta, vec = bwd_stats(da, y, gamma, beta, mean, var, eps,
                                   stats)
    if x.device.type == "cpu":
        dx, dw = fused_conv3x3_bn_relu_bwd_plain(da, x, y, w, vec)
        return dx, dw, dgamma, dbeta
    _card(x, da, y, w)
    n, c, h, wd = x.shape
    o = w.shape[0]
    bf16 = x.dtype == torch.bfloat16
    x, da, y, w = (t.contiguous() for t in (x, da, y, w))
    vec = vec.contiguous()
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    sm = _sm_count(_index(x.device))
    splits, rows = wgrad_splits(n, h, wd, c, o, sm)
    chunk = _CHUNK_BF16 if bf16 else _CHUNK
    dsplits, cps = dgrad_splits(n, h, wd, c, o, sm, chunk)
    pr, pc = wgrad_patch(h, wd)
    # the weights in dgrad's layout: bf16 copied, or fp32 split into TF32
    # hi and lo planes
    wsp = (torch.empty(9 * c * _cdiv(o, chunk) * chunk, dtype=torch.bfloat16,
                       device=x.device) if bf16 else
           torch.empty(2 * 9 * c * _cdiv(o, chunk) * chunk,
                       dtype=torch.int32, device=x.device))
    dpart = (torch.empty((dsplits,) + tuple(x.shape), dtype=torch.float32,
                         device=x.device) if dsplits > 1 else None)
    wpart = (torch.empty((splits, o, 9 * c), dtype=torch.float32,
                         device=x.device) if splits > 1 else None)
    lib = _native.load("conv_bwd", _bind)
    entry = lib.conv3x3_bn_relu_bwd_bf16 if bf16 else lib.conv3x3_bn_relu_bwd
    with torch.cuda.device(x.device):
        rc = entry(
            vec.data_ptr(), da.data_ptr(), y.data_ptr(), x.data_ptr(),
            w.data_ptr(), wsp.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            None if dpart is None else dpart.data_ptr(),
            None if wpart is None else wpart.data_ptr(), n, h, wd, c, o,
            dsplits, cps, splits, rows // (pr * pc or _PIXELS),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = lib.conv3x3_bn_relu_bwd_error_string(rc).decode()
        raise MXNetError(f"conv3x3_bn_relu_bwd launch failed: {msg} (code "
                         f"{rc}; N={n} H={h} W={wd} C={c} O={o} "
                         f"{x.dtype})")
    launches = fused_conv3x3_bn_relu_bwd.kernel_launches
    fused_conv3x3_bn_relu_bwd.launches += 1
    fused_conv3x3_bn_relu_bwd.bf16_launches += int(bf16)
    fused_conv3x3_bn_relu_bwd.shape_launches[(n, h, wd, c, o)] += 1
    if _insight._counting:
        # dgrad and wgrad: 9 taps of an (N*H*W, C) x (C, O) product each
        _insight.add_flops(2 * 2 * 9 * n * h * wd * c * o)
    tag = "_bf16" if bf16 else ""
    launches["wcopy_bf16" if bf16 else "wsplit"] += 1
    launches["dgrad" + tag] += 1
    launches["dgrad_reduce" + tag] += int(dsplits > 1)
    launches["wgrad" + tag] += 1
    launches["wgrad_reduce" + tag] += int(splits > 1)
    return dx, dw, dgamma, dbeta


fused_conv3x3_bn_relu_bwd.launches = 0
fused_conv3x3_bn_relu_bwd.bf16_launches = 0
fused_conv3x3_bn_relu_bwd.shape_launches = collections.Counter()
fused_conv3x3_bn_relu_bwd.kernel_launches = {
    "wsplit": 0, "dgrad": 0, "dgrad_reduce": 0, "wgrad": 0,
    "wgrad_reduce": 0, "wcopy_bf16": 0, "dgrad_bf16": 0,
    "dgrad_reduce_bf16": 0, "wgrad_bf16": 0, "wgrad_reduce_bf16": 0}


class FusedCBRFunction(torch.autograd.Function):
    """``relu(bn_train(conv3x3_s1_same(x, w)))`` returning ``(a, mean,
    var)`` (reference: ``fused_cbr_train``): the forward is
    :func:`conv3x3_bn_relu_ref`, the backward
    :func:`fused_conv3x3_bn_relu_bwd`. mean and var feed only the
    running-statistics update: their cotangents are dropped (:203). The
    backward is first-order only (``autograd.grad(..., create_graph=True)``
    refuses it)."""

    _first_order_only = True

    @staticmethod
    def forward(ctx, x, w, gamma, beta, eps):
        from ..parallel.collectives import batch_stats_group
        # the group is read once here and kept for the backward, which
        # autograd runs on its own thread
        ctx.stats = batch_stats_group()
        a, y, mean, var = conv3x3_bn_relu_ref(x, w, gamma, beta, eps,
                                              ctx.stats)
        ctx.save_for_backward(x, w, gamma, beta, y, mean, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return a, mean, var

    @staticmethod
    def backward(ctx, da, _dmean, _dvar):
        x, w, gamma, beta, y, mean, var = ctx.saved_tensors
        dx, dw, dgamma, dbeta = fused_conv3x3_bn_relu_bwd(
            da.contiguous(), x, y, w, gamma, beta, mean, var, ctx.eps,
            ctx.stats)
        return dx, dw, dgamma, dbeta, None
