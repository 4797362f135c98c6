"""The ``npx`` operators, as plain PyTorch: every public name of the
JAX package's ``npx``.

Counterpart of ``mxnet_tpu/numpy_extension/__init__.py``: the layer ops
(fully_connected, convolution, deconvolution, (modulated_)deformable_
convolution, pooling, batch_norm, fused_conv_bn_relu, flatten,
layer_norm, group_norm, instance_norm, dropout, activation, leaky_relu,
gelu, embedding; from ``ops/quantization.py`` the int8 and fp8 ops,
imported at the call: the ops import this module's activation table), and
the operator tail: the elementwise ops (relu, sigmoid, rsqrt, rcbrt, erf,
erfinv, gamma, gammaln, digamma), softmin and the masked softmaxes,
l2_normalization, one_hot, topk, the gathers and scatters, the sequence
ops, the shape ops (reshape with MXNet's codes, split_v2,
space_to_depth, ...), batch_dot, smooth_l1, softmax_cross_entropy, the
AMP casts, the interleaved attention matmuls and
``multi_head_attention`` (``ops/attention.py``: kernels 1-3 on the
card), ``rnn`` (``ops/rnn.py``), the detection ops (``ops/bbox.py``,
``ops/multibox.py``), the control flow (``foreach``, ``while_loop``,
``cond``: loops on the host, so gradients reach whatever the body
touches), the extension samplers and ``npx.random``, and the state and
device helpers. The reference's rules are kept where torch's differ: an
out-of-range ``gather_nd`` index reads the clamped element and passes no
gradient, ``one_hot`` gives an off-value row, the scatters drop such
indices (through a spare row, so no index check fires on the device),
``topk`` and the detection ops keep equal scores in index order (stable
sorts). ``nonzero`` and ``constraint_check`` read the host, as the
reference's eager paths do.

Each op that the JAX package dispatches under a name passes its floating
inputs through ``amp._maybe_cast_op_inputs`` under that name (the AMP
policy, off unless ``amp.init()`` ran): ``fully_connected``,
``convolution``, ``pooling:<pool_type>``, ``batch_norm``,
``fused_conv_bn_relu``, ``layer_norm``, ``softmax``,
``activation:<act_type>``, ``leaky_relu:<act_type>`` (``gelu`` is the
reference's ``leaky_relu`` with act_type "gelu"), ``embedding``, and of
the tail ``erf``, ``erfinv``, ``gammaln``, ``digamma``, the softmaxes,
``l2_normalization``, ``batch_dot``, ``smooth_l1``,
``softmax_cross_entropy`` (dense labels; the sparse form is
``sparse_softmax_xent``) and the interleaved matmuls; ``rnn`` is
``rnn:<mode>`` and ``gamma`` / ``index_update`` / ``index_add`` are
``<lambda>``, names no AMP list holds, as in the reference.
``fully_connected`` and ``layer_norm`` then promote their inputs to their
common floating dtype, as jnp does (bf16 with fp32 gives fp32).

Every public op takes ``mx.np`` arrays as well as tensors: given an
``ndarray`` it goes through ``numpy.multiarray._invoke`` and returns
``ndarray``s (``_arrays``); given tensors it runs directly. The layers and
the model zoo call the undecorated ops of :data:`tensor_ops`, so their
tensor calls pay no check for arrays. The host planes' hooks (``_hooks``:
profiler span, ``invoke.nan_output``, ``invoke.ops_total``) run on both
paths under the reference's ``_invoke`` names (:data:`_REF_NAMES`:
``fully_connected``, ``activation:<act_type>``, ``pooling:<pool_type>``,
``leaky_relu:gelu`` for ``gelu``, ``reshape`` for ``flatten``, ``getitem``
for ``slice_axis``, ...), so a Gluon forward counts and names its ops as
the reference's does. While every plane is off, ``tensor_ops`` holds the
undecorated functions themselves; ``_hooks.refresh`` swaps in their
hooked versions while one is on.
``fully_connected``, ``layer_norm``, ``softmax`` / ``log_softmax``,
``embedding`` and ``pooling`` take the reference's arguments
(``num_hidden`` / ``no_bias``; ``axis``; ``length`` / ``use_length``, the
masked positions written 0; ``input_dim`` / ``output_dim`` / ``dtype`` /
``sparse_grad``: a row-sparse weight gradient; the "sum"
and "lp" pool types). ``pooling_convention`` "full" and "same" compute as
"valid" does, as in the reference, whose ``pooling`` reads the argument
nowhere. ``waitall``, ``save`` and ``load`` (``.npz``) are the
reference's; a file either package writes, the other loads.

``batch_norm`` and ``fused_conv_bn_relu`` update the running statistics in
place while training, as the reference's aux arrays are: ``m * running +
(1 - m) * batch`` under ``torch.no_grad()``, so the update is never part
of a recorded graph.
"""
from __future__ import annotations

import builtins
import functools
import inspect
import math
import types

import numpy as onp
import torch
import torch.nn.functional as F

from .. import _hooks
from ..base import MXNetError, np_dtype
from ..context import cpu, gpu, num_gpus, resolve_device
from ..numpy import _ops
from ..numpy.multiarray import _invoke_impl, _wrap, _writeback, array, ndarray
from ..ops import bbox as _bbox
from ..ops import multibox as _multibox

__all__ = ["fully_connected", "convolution", "deconvolution",
           "deformable_convolution", "modulated_deformable_convolution",
           "pooling", "batch_norm", "fused_conv_bn_relu", "flatten",
           "layer_norm", "group_norm", "instance_norm", "dropout",
           "softmax",
           "log_softmax", "activation",
           "leaky_relu", "gelu", "embedding", "quantize_v2", "dequantize",
           "quantized_fully_connected", "quantized_conv",
           "quantized_dense_fused", "quantized_conv_fused",
           "fp8_dense_fused", "pick", "slice_axis", "waitall", "save",
           "load",
           # the operator tail
           "relu", "sigmoid", "rsqrt", "rcbrt", "erf", "erfinv", "gamma",
           "gammaln", "digamma", "softmin", "masked_softmax",
           "masked_log_softmax", "l2_normalization", "one_hot", "topk",
           "gather_nd", "scatter_nd", "index_update", "index_add",
           "sequence_mask", "sequence_last", "sequence_reverse",
           "reshape_like", "arange_like", "broadcast_like", "slice",
           "slice_like", "where", "batch_dot", "smooth_l1",
           "softmax_cross_entropy", "reshape", "split_v2", "space_to_depth",
           "depth_to_space", "shape_array", "size_array", "constraint_check",
           "amp_cast", "interleaved_matmul_selfatt_qk",
           "interleaved_matmul_selfatt_valatt",
           "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt",
           "multi_head_attention", "rnn", "box_iou", "box_nms", "box_encode",
           "box_decode", "bipartite_matching", "multibox_prior",
           "multibox_target", "multibox_detection",
           # not ops over arrays: no tensor_ops entry
           "nonzero", "amp_multicast", "savez", "foreach", "while_loop",
           "cond", "set_np", "reset_np", "is_np_array", "is_np_shape",
           "is_np_default_dtype", "use_np", "use_np_array", "use_np_shape",
           "cpu", "gpu", "num_gpus", "seed", "np_dtype", "bernoulli",
           "uniform_n", "normal_n", "clip_global_norm", "random"]


#: the reference's ``_invoke`` name of each op (a str, the argument whose
#: value follows a prefix, or a function of the bound arguments), for the
#: host planes' hooks; the AMP policy is the op's own (each op casts its
#: inputs by that name)
_REF_NAMES = {
    "pooling": ("pooling:", "pool_type"),
    "rnn": ("rnn:", "mode"),
    "softmax_cross_entropy": lambda a: "sparse_softmax_xent"
    if a["sparse_label"] else "softmax_cross_entropy",
    "gamma": "<lambda>",
    "index_update": "<lambda>",
    "index_add": "<lambda>",
    "softmin": "softmax",
    "reshape": "npx_reshape",
    "slice": "getitem",
    "slice_like": "getitem",
    "activation": ("activation:", "act_type"),
    "leaky_relu": ("leaky_relu:", "act_type"),
    "gelu": "leaky_relu:gelu",
    "flatten": "reshape",
    "slice_axis": "getitem",
}


def _ref_name(fn, args, kwargs):
    name = _REF_NAMES.get(fn.__name__, fn.__name__)
    if isinstance(name, str):
        return name
    bound = _signature(fn).bind(*args, **kwargs)
    bound.apply_defaults()
    if callable(name):
        return name(bound.arguments)
    prefix, arg = name
    return prefix + str(bound.arguments[arg])


@functools.lru_cache(maxsize=None)
def _signature(fn):
    return inspect.signature(fn)


def _array_call(fn, args, kwargs):
    # the AMP lookup name stays "npx.<op>", which no list holds: the op
    # casts its own inputs
    if _hooks.on:
        return _hooks.call(_invoke_impl, _ref_name(fn, args, kwargs),
                           (fn, args, kwargs, "npx." + fn.__name__), {},
                           wrapped=True)
    return _invoke_impl(fn, args, kwargs, "npx." + fn.__name__)


def _arrays(fn):
    """``fn`` over tensors, taking ``mx.np`` arrays too: an ``ndarray``
    argument sends the call through ``_invoke`` (``ndarray``s out);
    tensors call ``fn`` directly."""
    @functools.wraps(fn)
    def op(*args, **kwargs):
        for a in args:
            if type(a) is ndarray:
                return _array_call(fn, args, kwargs)
        for a in kwargs.values():
            if type(a) is ndarray:
                return _array_call(fn, args, kwargs)
        return fn(*args, **kwargs)
    return op

# the JAX package's ``_ACTS`` table; its "gelu" is jax.nn.gelu's default,
# the tanh approximation
_ACTS = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "log_sigmoid": F.logsigmoid,
    "mish": F.mish,
}


def _cast(name, *tensors):
    return _amp._maybe_cast_op_inputs(name, tensors)


def _promoted(*tensors):
    """The tensors (None left out of the rule) in their common dtype, by
    torch's promotion, which is jnp's for the floating types."""
    dt = functools.reduce(torch.promote_types,
                          [t.dtype for t in tensors if t is not None])
    return [None if t is None else t.to(dt) for t in tensors]


@_arrays
def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    """``x @ weight.T + bias`` with weight layout (units, in_units)
    (reference: src/operator/nn/fully_connected.cc), in the inputs' common
    dtype (bf16 x with fp32 weight runs in fp32, as in the reference): the
    product in x's and weight's, then the bias added with promotion.
    ``no_bias`` drops the bias; ``num_hidden`` is the reference's
    (units, read from the weight)."""
    if no_bias:
        bias = None
    x, weight, bias = _cast("fully_connected", x, weight, bias)
    x, weight = _promoted(x, weight)
    if flatten:
        x = x.reshape(x.shape[0], -1)
    if bias is None or bias.dtype == x.dtype:
        return F.linear(x, weight, bias)
    return F.linear(x, weight) + bias


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _channel_first(layout, nd):
    if layout is not None and layout != {1: "NCW", 2: "NCHW",
                                         3: "NCDHW"}[nd]:
        raise MXNetError(f"layout {layout!r}: only the channel-first "
                         "layouts are part of this slice of the port")


def _spatial_pad(pad):
    """F.pad's argument for symmetric ``pad`` per spatial axis."""
    return [p for p in reversed(pad) for _ in range(2)]


@_arrays
def convolution(data=None, weight=None, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=1, num_group=1,
                workspace=1024, no_bias=False, cudnn_tune=None,
                cudnn_off=False, layout=None):
    """N-d convolution, weight (O, I/groups, *kernel) (reference:
    convolution.cc). Channel-first layouts; the library convolution, as
    the reference leaves it to XLA."""
    nd = data.ndim - 2
    _channel_first(layout, nd)
    data, weight, bias = _cast("convolution", data, weight, bias)
    b = None if no_bias else bias
    return _CONV[nd](data, weight, b, stride=tuple(stride or (1,) * nd),
                     padding=tuple(pad or (0,) * nd),
                     dilation=tuple(dilate or (1,) * nd), groups=num_group)


_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@_arrays
def deconvolution(data=None, weight=None, bias=None, kernel=None,
                  stride=None, dilate=None, pad=None, adj=None,
                  target_shape=None, num_filter=1, num_group=1,
                  workspace=512, no_bias=True, cudnn_tune=None,
                  cudnn_off=False, layout=None):
    """N-d transposed convolution, weight (C_in, C_out/groups, *kernel)
    (reference: deconvolution.cc), as the library's ``conv_transpose``.
    ``adj`` is the extra size on one side of each output axis (torch's
    ``output_padding``; the JAX package reads it nowhere, so there a
    nonzero ``adj`` gives the smaller output)."""
    nd = data.ndim - 2
    _channel_first(layout, nd)
    data, weight, bias = _cast("deconvolution", data, weight, bias)
    b = None if no_bias else bias
    return _DECONV[nd](data, weight, b, stride=tuple(stride or (1,) * nd),
                       padding=tuple(pad or (0,) * nd),
                       output_padding=tuple(adj or (0,) * nd),
                       groups=num_group,
                       dilation=tuple(dilate or (1,) * nd))


def _deformable(x, offset, weight, bias, kernel, stride, pad, dilate,
                num_group, num_deformable_group, mask):
    from ..ops.deformable import deformable_conv2d
    return deformable_conv2d(
        x, offset, weight, bias, kernel=tuple(kernel),
        stride=tuple(stride or (1, 1)), pad=tuple(pad or (0, 0)),
        dilate=tuple(dilate or (1, 1)), num_group=num_group,
        num_deformable_group=num_deformable_group, mask=mask)


@_arrays
def deformable_convolution(data=None, offset=None, weight=None, bias=None,
                           kernel=None, stride=None, dilate=None, pad=None,
                           num_filter=1, num_group=1,
                           num_deformable_group=1, workspace=1024,
                           no_bias=False, layout=None, **kwargs):
    """DCN v1 (reference: contrib/deformable_convolution.cc): bilinear
    sampling at the offset positions, then one product over the channels
    and taps (``ops/deformable.py``). NCHW only."""
    if layout not in (None, "NCHW"):
        raise MXNetError("deformable_convolution supports NCHW only")
    return _deformable(data, offset, weight, None if no_bias else bias,
                       kernel, stride, pad, dilate, num_group,
                       num_deformable_group, None)


@_arrays
def modulated_deformable_convolution(data=None, offset=None, mask=None,
                                     weight=None, bias=None, kernel=None,
                                     stride=None, dilate=None, pad=None,
                                     num_filter=1, num_group=1,
                                     num_deformable_group=1, workspace=1024,
                                     no_bias=False, layout=None, **kwargs):
    """DCN v2 (reference: contrib/modulated_deformable_convolution.cc):
    DCN v1 with each sampled value times ``mask``. NCHW only."""
    if layout not in (None, "NCHW"):
        raise MXNetError("modulated_deformable_convolution supports NCHW "
                         "only")
    return _deformable(data, offset, weight, None if no_bias else bias,
                       kernel, stride, pad, dilate, num_group,
                       num_deformable_group, mask)


def _window_sum(x, kernel, stride, pads, nd):
    """Sums over pooling windows of zero-padded ``x``."""
    x = F.pad(x, pads)
    if nd == 1:
        return F.avg_pool2d(x.unsqueeze(-2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(-2)
    return _AVG_POOL[nd](x, kernel, stride, divisor_override=1)


@_arrays
def pooling(data, kernel=1, stride=None, pad=None, pool_type="max",
            pooling_convention="valid", global_pool=False, p_value=2,
            count_include_pad=True, layout="NCHW", cudnn_off=False):
    """Max, avg, sum and lp pooling, windowed or global (reference:
    pooling.cc): max pads with -inf, the others with zeros; avg divides by
    the window (``count_include_pad``) or by its valid elements; lp is
    ``(sum |x|^p)^(1/p)``. ``pooling_convention`` is accepted and, as in
    the reference, the windows are the "valid" ones whatever its value."""
    nd = data.ndim - 2
    _channel_first(layout, nd)
    data, = _cast(f"pooling:{pool_type}", data)
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise MXNetError(f"unknown pool_type {pool_type!r}")
    if pooling_convention not in ("valid", "full", "same"):
        raise MXNetError(f"unknown pooling_convention "
                         f"{pooling_convention!r}")
    spatial = tuple(range(2, data.ndim))
    if global_pool:
        if pool_type == "max":
            return data.amax(dim=spatial, keepdim=True)
        if pool_type == "avg":
            return data.mean(dim=spatial, keepdim=True)
        if pool_type == "sum":
            return data.sum(dim=spatial, keepdim=True)
        return data.abs().pow(p_value).sum(dim=spatial, keepdim=True) \
            .pow(1.0 / p_value)
    kernel = (kernel,) * nd if isinstance(kernel, int) else tuple(kernel)
    stride = tuple(stride) if stride else kernel
    pads = _spatial_pad(tuple(pad) if pad else (0,) * nd)
    if pool_type == "max":
        return _MAX_POOL[nd](F.pad(data, pads, value=-math.inf), kernel,
                             stride)
    if pool_type == "sum":
        return _window_sum(data, kernel, stride, pads, nd)
    if pool_type == "lp":
        return _window_sum(data.abs().pow(p_value), kernel, stride, pads,
                           nd).pow(1.0 / p_value)
    avg = _AVG_POOL[nd](F.pad(data, pads), kernel, stride)
    if count_include_pad:
        return avg
    ones = torch.ones_like(data[:1, :1])
    return avg / _AVG_POOL[nd](F.pad(ones, pads), kernel, stride)


def _batch_stats_group():
    from ..parallel.collectives import batch_stats_group
    return batch_stats_group()


def _update_running(running_mean, running_var, mean, var, momentum):
    """``m * running + (1 - m) * batch``, in place, outside any graph."""
    m = momentum
    with torch.no_grad():
        for run, batch in ((running_mean, mean), (running_var, var)):
            run.copy_((m * run + (1 - m) * batch.detach()).to(run.dtype))


@_arrays
def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False):
    """Batch normalization over ``axis`` (reference: batch_norm.cc, as the
    JAX package computes it). Training (``autograd.is_training()`` and not
    ``use_global_stats``): single-pass fp32 statistics ``E[x^2] - E[x]^2``
    (fp64 for fp64 inputs, as the fused route's) clamped at 0, and the
    running statistics updated in place; otherwise the running statistics.
    The normalization is the folded per-channel ``x * scale + shift``.
    The statistics are the per-channel sums of x and x^2 summed over
    ``parallel.collectives.batch_stats_group()`` (inside its
    ``sync_batch_stats`` scope: a dp step, a SyncBatchNorm, a BatchNorm
    under a Trainer over a dist store, the global batch's; else this
    rank's own, where the sum is the identity), over this rank's count
    times the group's ranks."""
    from .. import autograd
    x, gamma, beta = _cast("batch_norm", x, gamma, beta)
    training = autograd.is_training() and not use_global_stats
    red = tuple(i for i in range(x.ndim) if i != axis)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    if training:
        # differentiably: the backward sums the cotangents of the shared
        # statistics over the group the same way
        stats = _batch_stats_group()
        xf = x.to(acc)
        c = x.shape[axis]
        m = xf.numel() // c * stats.size
        tot = stats.gsum(torch.cat([xf.sum(dim=red), (xf * xf).sum(dim=red)]))
        mean = tot[:c] / m
        var = torch.clamp(tot[c:] / m - mean * mean, min=0.0)
    else:
        mean, var = running_mean, running_var
    g = torch.ones_like(gamma) if fix_gamma else gamma
    inv = torch.rsqrt((var + eps).to(acc))
    scale = (inv * g).to(x.dtype).reshape(shape)
    shift = (beta - mean * inv * g).to(x.dtype).reshape(shape)
    out = x * scale + shift
    if training:
        _update_running(running_mean, running_var, mean, var, momentum)
    return (out, mean, var) if output_mean_var else out


@_arrays
def fused_conv_bn_relu(x, weight, gamma, beta, running_mean, running_var,
                       momentum=0.9, eps=1e-5):
    """Training-mode ``relu(bn(conv3x3_s1(x, w)))`` whose backward is
    kernel 8 (``ops/conv_bwd.py``: the CUDA kernel for a CUDA tensor, its
    plain version for a CPU tensor). NCHW in and out, weight OIHW; the
    running statistics update as :func:`batch_norm`'s do, from the
    two-pass batch statistics of the fused forward."""
    from ..ops.conv_bwd import FusedCBRFunction
    x, weight, gamma, beta = _cast("fused_conv_bn_relu", x, weight, gamma,
                                   beta)
    out, mean, var = FusedCBRFunction.apply(x, weight, gamma, beta,
                                            float(eps))
    _update_running(running_mean, running_var, mean, var, momentum)
    return out


@_arrays
def flatten(x):
    """(N, ...) -> (N, prod(...)) (reference: npx.flatten)."""
    return x.reshape(x.shape[0], -1)


@_arrays
def layer_norm(data, gamma=None, beta=None, axis=-1, eps=1e-5):
    """LayerNorm over ``axis`` (reference: layer_norm.cc), returning the
    common dtype of x, gamma and beta. An fp32 or fp64 x takes
    ``F.layer_norm``; a bf16 or fp16 x is normalized in its own dtype, as
    the reference's jnp computes it: the statistics in fp32 and rounded to
    x's dtype, then ``(x - mean) * rsqrt(var + eps)`` in x's dtype (each
    step rounded), then the affine in the common dtype (fp32 for fp32
    gamma)."""
    if axis not in (-1, data.ndim - 1):
        out = layer_norm(data.movedim(axis, -1), gamma, beta, -1, eps)
        return out.movedim(-1, axis)
    x, gamma, beta = _cast("layer_norm", data, gamma, beta)
    dt = torch.promote_types(torch.promote_types(x.dtype, gamma.dtype),
                             beta.dtype)
    if x.dtype not in (torch.bfloat16, torch.float16):
        return F.layer_norm(x.to(dt), (x.shape[-1],), gamma.to(dt),
                            beta.to(dt), eps)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True).to(x.dtype)
    var = xf.var(dim=-1, unbiased=False, keepdim=True).to(x.dtype)
    # each step rounded to x's dtype once (torch's own bf16 rsqrt on the
    # CPU is not the rounded fp32 rsqrt)
    xhat = (x - mean) * torch.rsqrt((var + eps).float()).to(x.dtype)
    return xhat.to(dt) * gamma.to(dt) + beta.to(dt)


def _affine_channels(out, g, b):
    shape = [1, out.shape[1]] + [1] * (out.ndim - 2)
    return out * g.reshape(shape) + b.reshape(shape)


@_arrays
def group_norm(data, gamma=None, beta=None, num_groups=1, eps=1e-5):
    """GroupNorm on (N, C, ...) (reference: group_norm.cc): statistics
    over each group of ``C / num_groups`` channels and every spatial
    position, then the per-channel affine."""
    x, gamma, beta = _cast("group_norm", data, gamma, beta)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    red = tuple(range(2, xg.ndim))
    mean = xg.mean(dim=red, keepdim=True)
    var = xg.var(dim=red, unbiased=False, keepdim=True)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return _affine_channels(out, gamma, beta)


@_arrays
def instance_norm(data, gamma=None, beta=None, eps=1e-3):
    """InstanceNorm on (N, C, ...) (reference: instance_norm.cc):
    statistics over each sample's channel, then the per-channel affine."""
    x, gamma, beta = _cast("instance_norm", data, gamma, beta)
    red = tuple(range(2, x.ndim))
    mean = x.mean(dim=red, keepdim=True)
    var = x.var(dim=red, unbiased=False, keepdim=True)
    return _affine_channels((x - mean) * torch.rsqrt(var + eps), gamma, beta)


@_arrays
def dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False,
            generator=None):
    """Inverted dropout (reference: dropout.cc) while
    ``autograd.is_training()`` (always with ``mode="always"``); one keep
    draw shared along each axis of ``axes``. The mask comes from
    ``generator``, else from the default generator of the tensor's
    device (``random.dropout_mask``); a dropped element is 0 whatever its
    value."""
    from .. import autograd
    from .. import random as _random
    if not p or (mode != "always" and not autograd.is_training()):
        return data
    like = data
    if axes:
        shape = list(data.shape)
        for ax in axes:
            shape[ax] = 1
        like = data.new_empty(shape)
    mask = _random.dropout_mask(like, p, generator)
    return torch.where(mask.bool(), data / (1.0 - p), data.new_zeros(()))


def _length_mask(h, length, axis):
    """Positions below ``length`` along ``axis`` (reference:
    ``_length_mask``: ``length`` has the data's shape without the axis, or
    is 1-d over the first axis)."""
    ax = axis % h.ndim
    shape = [1] * h.ndim
    shape[ax] = h.shape[ax]
    pos = torch.arange(h.shape[ax], device=h.device).reshape(shape)
    ln = length.unsqueeze(ax) if length.ndim == h.ndim - 1 else \
        length.reshape((length.shape[0],) + (1,) * (h.ndim - 1))
    return pos < ln


def _softmax(fn, name, data, length, axis, temperature, use_length, dtype):
    data, = _cast(name, data)
    h = data / temperature if temperature else data
    out_dt = _dtype(dtype) or data.dtype
    if length is None and not use_length:
        return fn(h, dim=axis).to(out_dt)
    mask = _length_mask(h, length, axis)
    out = fn(h.masked_fill(~mask, -math.inf), dim=axis)
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device)).to(out_dt)


def _dtype(dtype):
    from ..base import torch_dtype
    return torch_dtype(dtype)


@_arrays
def softmax(data, length=None, axis=-1, temperature=None, use_length=False,
            dtype=None):
    """Softmax along ``axis`` (reference: softmax.cc), in the input's dtype
    unless ``dtype`` is given; fp32 under the AMP policy. With ``length``
    the positions at or past it are left out and written 0."""
    return _softmax(torch.softmax, "softmax", data, length, axis,
                    temperature, use_length, dtype)


@_arrays
def log_softmax(data, axis=-1, temperature=None, dtype=None,
                use_length=False, length=None):
    """Log-softmax along ``axis`` (reference: softmax.cc log variant); the
    masked positions write 0, as the softmax kernel's store does."""
    return _softmax(torch.log_softmax, "log_softmax", data, length, axis,
                    temperature, use_length, dtype)


@_arrays
def activation(data, act_type="relu"):
    """Reference: src/operator/nn/activation.cc."""
    if act_type not in _ACTS:
        raise MXNetError(f"unknown act_type {act_type!r}")
    data, = _cast(f"activation:{act_type}", data)
    return _ACTS[act_type](data)


@_arrays
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, generator=None,
               **kwargs):
    """Reference: src/operator/leaky_relu.cc: ``leaky`` (``slope``),
    ``prelu`` (the learned ``gamma``, broadcast over axis 1 when it has
    one element per channel), ``elu`` (alpha ``slope``), ``selu``,
    ``gelu`` (exact erf) and ``rrelu``. ``rrelu`` takes the midpoint of
    ``[lower_bound, upper_bound]`` as its slope, as the reference does,
    outside training; while ``autograd.is_training()`` each element's
    slope is drawn uniformly from the bounds (upstream MXNet's training
    rule) from ``generator``, else from the default generator of the
    tensor's device. ``elu`` and ``selu`` are fp32 under the AMP policy
    (conditional fp32 entries)."""
    if act_type == "gelu":
        return gelu(data)
    data, = _cast(f"leaky_relu:{act_type}", data)
    if act_type == "leaky":
        return F.leaky_relu(data, slope)
    if act_type == "prelu":
        g = gamma
        if g.numel() > 1 and data.ndim > 1 and g.shape[0] == data.shape[1]:
            g = g.reshape((1, -1) + (1,) * (data.ndim - 2))
        return torch.where(data >= 0, data, g * data)
    if act_type == "elu":
        return F.elu(data, slope)
    if act_type == "selu":
        return F.selu(data)
    if act_type == "rrelu":
        from .. import autograd
        from .. import random as _random
        if not autograd.is_training():
            return F.leaky_relu(data, (lower_bound + upper_bound) / 2.0)
        gen = generator if generator is not None \
            else _random.default_generator(data.device)
        _random.note_draw(gen)
        a = torch.empty_like(data).uniform_(lower_bound, upper_bound,
                                            generator=gen)
        return torch.where(data >= 0, data, a * data)
    raise MXNetError(f"unknown leaky_relu act_type {act_type!r}")


@_arrays
def gelu(x, approximation="erf"):
    """GELU, as ``npx.leaky_relu(act_type="gelu")`` computes it: exact
    (erf) by default, dispatched under its name there; ``approximation=
    "tanh"`` takes the tanh form (``nn.GELU(approximation="tanh")``)."""
    if approximation not in ("erf", "tanh"):
        raise MXNetError(f"GELU approximation must be 'erf' or 'tanh', got "
                         f"{approximation!r}")
    x, = _cast("leaky_relu:gelu", x)
    return F.gelu(x, approximate="none" if approximation == "erf"
                  else "tanh")


@_arrays
def embedding(ids, weight, input_dim=None, output_dim=None, dtype="float32",
              sparse_grad=False):
    """Row gather ``weight[ids]`` (reference: indexing_op.cc Embedding;
    ``input_dim`` / ``output_dim`` / ``dtype`` as the reference takes them,
    the rows in the weight's dtype), with
    the reference's ``jnp.take`` rule for ids out of range: an id in
    [-V, 0) wraps from the end, any other out-of-range id gives a row of
    NaN whose gradient reaches no weight row. Float ids truncate. The rule
    is decided from the ids' values before the gather (a clamped id is
    gathered and its row overwritten), so no index check fires on the
    device. ``sparse_grad=True`` (reference: numpy_extension
    ``embedding``, :581-613) gives a recorded call's weight a row-sparse
    gradient: :class:`_SparseEmbedding`'s backward hands autograd a torch
    COO tensor of the call's rows, which the weight's ``grad`` reads as a
    ``RowSparseNDArray`` in the reference's encoding. Inside a hybridized
    call (or ``functional_call``) the gradient is dense, as the
    reference's traced embedding is."""
    weight, = _cast("embedding", weight)
    v = weight.shape[0]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + v, idx)
    bad = (idx < 0) | (idx >= v)
    safe = idx.clamp(0, max(v - 1, 0))
    if sparse_grad and _records_sparse(weight):
        out = _SparseEmbedding.apply(safe, weight)
    else:
        out = F.embedding(safe, weight)
    return out.masked_fill(bad.unsqueeze(-1), float("nan"))


def _records_sparse(weight):
    """Whether an embedding of ``weight`` records a row-sparse gradient:
    the weight is differentiated, grad mode is on and no hybridized call
    (plain scope) runs the forward."""
    if not (weight.requires_grad and torch.is_grad_enabled()):
        return False
    from ..gluon.cached_graph import in_plain_scope
    return not in_plain_scope()


class _SparseEmbedding(torch.autograd.Function):
    """``weight[idx]`` whose weight gradient is row-sparse: the call's ids
    and the output's cotangent rows, nothing summed here (no host read).
    Inside ``autograd.backward`` they go to the weight's sink, and the
    backward concatenates every call's rows into one torch COO gradient
    (the reference's ``sparse.add`` of its cotangents: k slots for k
    rows); elsewhere (``autograd.grad``, a torch backward) they are a COO
    gradient autograd sums itself."""

    _first_order_only = True
    _mx_name = "embedding(sparse_grad=True)"

    @staticmethod
    def forward(ctx, idx, weight):
        ctx.save_for_backward(idx)
        ctx.weight = weight
        return F.embedding(idx, weight)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        idx, = ctx.saved_tensors
        ids, rows = idx.reshape(-1), dy.reshape(-1, dy.shape[-1])
        sink = getattr(ctx.weight, "_mx_sink", None)
        if sink is not None:
            sink.append((ids, rows))
            return None, None
        return None, torch.sparse_coo_tensor(
            ids.unsqueeze(0), rows, ctx.weight.shape, check_invariants=False)


@_arrays
def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """float32 -> (int8, min_range, max_range): see
    :func:`mxnet_tpu_torch.ops.quantization.quantize_v2`."""
    from ..ops.quantization import quantize_v2 as op
    return op(data, min_calib_range, max_calib_range, out_type)


@_arrays
def dequantize(data, min_range, max_range, out_type="float32"):
    """int8 -> float32: see :func:`mxnet_tpu_torch.ops.quantization.
    dequantize`."""
    from ..ops.quantization import dequantize as op
    return op(data, min_range, max_range, out_type)


@_arrays
def quantized_fully_connected(data, weight, x_scale, w_scale, bias=None,
                              flatten=True):
    """int8 x int8 -> fp32 dense layer: see :func:`mxnet_tpu_torch.ops.
    quantization.quantized_fully_connected`."""
    from ..ops.quantization import quantized_fully_connected as op
    return op(data, weight, x_scale, w_scale, bias=bias, flatten=flatten)


@_arrays
def quantized_conv(data, weight, x_scale, w_scale, bias=None, kernel=None,
                   stride=None, dilate=None, pad=None, num_filter=1,
                   num_group=1, layout="NCHW"):
    """int8 x int8 -> fp32 convolution: see :func:`mxnet_tpu_torch.ops.
    quantization.quantized_conv`."""
    from ..ops.quantization import quantized_conv as op
    return op(data, weight, x_scale, w_scale, bias=bias, kernel=kernel,
              stride=stride, dilate=dilate, pad=pad, num_filter=num_filter,
              num_group=num_group, layout=layout)


@_arrays
def quantized_conv_fused(data, weight, x_scale, w_scale, bias=None, act=None,
                         kernel=None, stride=None, dilate=None, pad=None,
                         num_filter=1, num_group=1, layout="NCHW"):
    """Fused quantize -> int8 conv -> dequant + bias + act: see
    :func:`mxnet_tpu_torch.ops.quantization.quantized_conv_fused`."""
    from ..ops.quantization import quantized_conv_fused as op
    return op(data, weight, x_scale, w_scale, bias=bias, act=act,
              kernel=kernel, stride=stride, dilate=dilate, pad=pad,
              num_filter=num_filter, num_group=num_group, layout=layout)


@_arrays
def quantized_dense_fused(data, weight, x_scale, w_scale, bias=None,
                          act=None, flatten=True):
    """int8 dense layer with a fused epilogue (kernel 6 on the card): see
    :func:`mxnet_tpu_torch.ops.quantization.quantized_dense_fused`."""
    from ..ops.quantization import quantized_dense_fused as op
    return op(data, weight, x_scale, w_scale, bias=bias, act=act,
              flatten=flatten)


@_arrays
def fp8_dense_fused(data, weight, x_scale, w_scale, bias=None, act=None,
                    flatten=True, fmt=None):
    """fp8-activation dense layer with a fused epilogue: see
    :func:`mxnet_tpu_torch.ops.quantization.fp8_dense_fused`."""
    from ..ops.quantization import fp8_dense_fused as op
    return op(data, weight, x_scale, w_scale, bias=bias, act=act,
              flatten=flatten, fmt=fmt)


@_arrays
def pick(data, index, axis=-1, mode="clip", keepdims=False):
    """``data``'s element at ``index`` along ``axis`` (reference:
    broadcast_reduce_op_index.cc ``pick``): "clip" clamps the index,
    "wrap" wraps it."""
    n = data.shape[axis]
    idx = index.to(torch.int64)
    idx = idx.clamp(0, n - 1) if mode == "clip" else idx.remainder(n)
    out = torch.take_along_dim(data, idx.unsqueeze(axis), dim=axis)
    return out if keepdims else out.squeeze(axis)


@_arrays
def slice_axis(data, axis, begin, end):
    """``data[begin:end]`` along ``axis`` (reference: ``slice_axis``)."""
    key = [builtins.slice(None)] * data.ndim
    key[axis] = builtins.slice(begin, end)
    return data[tuple(key)]


def waitall():
    """Wait for all the card's work (reference: ``npx.waitall``)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def save(file, arr_dict):
    """Save a dict (or list, or one array) of arrays as ``.npz``
    (reference: ``npx.save``); bf16 is written widened to fp32."""
    if isinstance(arr_dict, (ndarray, torch.Tensor)):
        arr_dict = {"arr_0": arr_dict}
    if isinstance(arr_dict, (list, tuple)):
        arr_dict = {f"arr_{i}": a for i, a in enumerate(arr_dict)}

    def host(v):
        if isinstance(v, ndarray):
            return v.asnumpy()
        if isinstance(v, torch.Tensor):
            v = v.detach()
            return (v.float() if v.dtype is torch.bfloat16 else v).cpu() \
                .numpy()
        return onp.asarray(v)
    onp.savez(file, **{k: host(v) for k, v in arr_dict.items()})


def load(file, ctx=None, device=None):
    """The dict of arrays of an ``.npz`` file (reference: ``npx.load``),
    on ``ctx`` / ``device`` or the current context, by the 32-bit rule
    (float64 arrays load as float32, as the reference's ``array``)."""
    with onp.load(file, allow_pickle=False) as data:
        return {k: array(data[k], ctx=ctx, device=device)
                for k in data.files}


# ---------------------------------------------------------------------------
# the operator tail: elementwise, masks, indexing, shapes, losses, casts
# ---------------------------------------------------------------------------

def _floating(x):
    """``x`` in a floating dtype: integers as the reference's
    transcendentals give them (float32, float64 from a 64-bit input)."""
    if x.is_floating_point():
        return x
    return x.to(torch.float64 if x.dtype == torch.int64 else torch.float32)


@_arrays
def relu(data):
    """``max(x, 0)`` (reference: ``npx.relu``)."""
    return torch.relu(data)


@_arrays
def sigmoid(data):
    """Logistic sigmoid (reference: ``npx.sigmoid``)."""
    return torch.sigmoid(_floating(data))


@_arrays
def rsqrt(data):
    """``1 / sqrt(x)`` (reference: elemwise_unary_op_pow.cc rsqrt)."""
    return torch.rsqrt(data)


@_arrays
def rcbrt(data):
    """``1 / cbrt(x)`` (reference: elemwise_unary_op_pow.cc rcbrt)."""
    return 1.0 / (torch.sign(data) * torch.abs(data).pow(1.0 / 3.0))


@_arrays
def erf(data):
    """The error function; fp32 under the AMP policy."""
    data, = _cast("erf", data)
    return torch.special.erf(_floating(data))


@_arrays
def erfinv(data):
    """The inverse error function; fp32 under the AMP policy."""
    data, = _cast("erfinv", data)
    return torch.special.erfinv(_floating(data))


@_arrays
def gamma(data):
    """``exp(gammaln(x))``, as the reference computes it: ``|Gamma(x)|``
    (reference dispatch name ``<lambda>``, which no AMP list holds)."""
    return torch.exp(torch.special.gammaln(_floating(data)))


@_arrays
def gammaln(data):
    """``log |Gamma(x)|``; fp32 under the AMP policy."""
    data, = _cast("gammaln", data)
    return torch.special.gammaln(_floating(data))


@_arrays
def digamma(data):
    """The digamma function; fp32 under the AMP policy."""
    data, = _cast("digamma", data)
    return torch.special.digamma(_floating(data))


@_arrays
def softmin(data, axis=-1, temperature=None, dtype=None):
    """``softmax(-x)`` (reference: ``npx.softmin``, dispatched as the
    softmax it calls)."""
    return _softmax(torch.softmax, "softmax", -data, None, axis,
                    temperature, False, dtype)


def _masked(fn, name, data, mask, axis, temperature, fill):
    data, = _cast(name, data)
    h = data / temperature if temperature else data
    m = mask.bool() if mask.dtype != torch.bool else mask
    out = fn(h.masked_fill(~m, -math.inf), dim=axis)
    return torch.where(m, out, torch.full((), fill, dtype=out.dtype,
                                          device=out.device))


@_arrays
def masked_softmax(data, mask, axis=-1, temperature=1.0):
    """Softmax over the positions where ``mask`` holds, 0 elsewhere (a
    row masked whole is 0)."""
    return _masked(torch.softmax, "masked_softmax", data, mask, axis,
                   temperature, 0.0)


@_arrays
def masked_log_softmax(data, mask, axis=-1, temperature=1.0):
    """Log-softmax over the positions where ``mask`` holds, -inf
    elsewhere."""
    return _masked(torch.log_softmax, "masked_log_softmax", data, mask,
                   axis, temperature, -math.inf)


@_arrays
def l2_normalization(data, eps=1e-10, mode="instance"):
    """``x / sqrt(sum x^2 + eps)`` over each instance, channel (axis 1) or
    spatial position set (reference: l2_normalization.cc)."""
    x, = _cast("l2_normalization", data)
    if mode == "channel":
        norm = torch.sqrt((x * x).sum(1, keepdim=True) + eps)
    elif mode == "spatial":
        norm = torch.sqrt((x * x).sum(tuple(range(2, x.ndim)),
                                      keepdim=True) + eps)
    else:
        norm = torch.sqrt((x.reshape(x.shape[0], -1) ** 2).sum(1) + eps) \
            .reshape((-1,) + (1,) * (x.ndim - 1))
    return x / norm


def _index_tensor(idx, device):
    """Integer indices as an int64 tensor (floats truncate, as the
    reference's ``astype(int32)``)."""
    if not isinstance(idx, torch.Tensor):
        idx = torch.as_tensor(onp.asarray(idx), device=device)
    return idx.to(device=device, dtype=torch.int64)


@_arrays
def one_hot(data, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    """Rows of ``depth``: ``on_value`` at the index, ``off_value``
    elsewhere; an index outside ``[0, depth)`` gives a row of
    ``off_value``, as ``jax.nn.one_hot`` does."""
    idx = _index_tensor(data, getattr(data, "device", None)
                        or resolve_device(None))
    dt = _dtype(dtype)
    hot = idx[..., None] == torch.arange(depth, device=idx.device)
    out = hot.to(dt) * (on_value - off_value) + off_value
    return out if dt.is_floating_point else out.to(torch.float32)


@_arrays
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The ``k`` largest (smallest with ``is_ascend``) along ``axis``
    (reference: ordering_op.cc): equal values in index order, as
    ``lax.top_k`` orders them, by a stable sort. ``ret_typ`` "indices"
    (in ``dtype``), "value" or "both"."""
    srt = torch.sort(data, dim=axis, descending=not is_ascend, stable=True)
    vals = srt.values.narrow(axis, 0, k)
    idx = srt.indices.narrow(axis, 0, k).to(_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx
    return idx


def _flat_index(idx, shape):
    """Row-major positions over ``shape[:M]`` of the (M, ...) indices
    ``idx``, each normalized from the end when negative, and a validity
    mask."""
    m = idx.shape[0]
    flat = torch.zeros(idx.shape[1:], dtype=torch.int64, device=idx.device)
    ok = torch.ones(idx.shape[1:], dtype=torch.bool, device=idx.device)
    for d in range(m):
        i = idx[d]
        i = torch.where(i < 0, i + shape[d], i)
        ok = ok & (i >= 0) & (i < shape[d])
        flat = flat * shape[d] + i
    return flat, ok


@_arrays
def gather_nd(data, indices):
    """``data[indices[0], ..., indices[M-1]]``: an index past either end
    reads the clamped position (a negative one first counts from the end)
    and passes no gradient, as the reference's gather and its transpose
    do."""
    idx = _index_tensor(indices, data.device)
    _, ok = _flat_index(idx, data.shape)
    key = []
    for d in range(idx.shape[0]):
        n = data.shape[d]
        i = torch.where(idx[d] < 0, idx[d] + n, idx[d])
        key.append(i.clamp(0, n - 1))
    out = data[tuple(key)]
    ok = ok.reshape(tuple(ok.shape) + (1,) * (out.ndim - ok.ndim))
    return torch.where(ok, out, out.detach())


def _scatter(base, idx, value, accumulate):
    """``base`` with ``value`` written (or added) at the (M, ...) indices;
    out-of-range indices are dropped, as the reference's scatter drops
    them: they land in one spare row that is cut off after."""
    m = idx.shape[0]
    lead, rest = tuple(base.shape[:m]), tuple(base.shape[m:])
    rows = math.prod(lead)
    flat, ok = _flat_index(idx, lead)
    flat = torch.where(ok, flat, torch.full_like(flat, rows))
    aug = torch.cat([base.reshape((rows,) + rest),
                     base.new_zeros((1,) + rest)])
    value = torch.broadcast_to(value.to(base.dtype),
                               tuple(flat.shape) + rest)
    out = aug.index_put((flat,), value, accumulate=accumulate)
    return out[:rows].reshape(base.shape)


@_arrays
def scatter_nd(data, indices, shape):
    """Zeros of ``shape`` with ``data`` added at ``indices`` (duplicates
    accumulate)."""
    idx = _index_tensor(indices, data.device)
    return _scatter(data.new_zeros(tuple(shape)), idx, data, True)


@_arrays
def index_update(data, indices, value):
    """``data`` with ``value`` set at ``indices`` (which of duplicate
    indices wins is undefined, as in the reference)."""
    idx = _index_tensor(indices, data.device)
    value = torch.as_tensor(value, device=data.device)
    return _scatter(data, idx, value, False)


@_arrays
def index_add(data, indices, value):
    """``data`` with ``value`` added at ``indices`` (duplicates
    accumulate)."""
    idx = _index_tensor(indices, data.device)
    value = torch.as_tensor(value, device=data.device)
    return _scatter(data, idx, value, True)


def _seq_mask(x, ln, axis):
    pos = torch.arange(x.shape[axis], device=x.device)
    mask = pos[:, None] < ln[None, :] if axis == 0 else \
        pos[None, :] < ln[:, None]
    return mask.reshape(tuple(mask.shape) + (1,) * (x.ndim - 2))


@_arrays
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """Positions at or past each sequence's length set to ``value``; axis
    0: (seq, batch, ...), axis 1: (batch, seq, ...)."""
    if not use_sequence_length or sequence_length is None:
        return data
    mask = _seq_mask(data, sequence_length, axis)
    return torch.where(mask, data, torch.full((), value, dtype=data.dtype,
                                              device=data.device))


@_arrays
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    """Each sequence's last element along ``axis`` (at its length - 1; a
    length past the sequence reads the fill value, NaN, as the
    reference's ``take_along_axis`` does)."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    xm = data.movedim(axis, 0)
    idx = (sequence_length - 1).long()
    return _ops.take_along_fill(
        xm, idx.reshape((1, -1) + (1,) * (xm.ndim - 2)), 0)[0]


@_arrays
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """Each sequence reversed in its first ``length`` steps along axis 0
    (the reference reads ``axis`` only without lengths; a length past the
    sequence reads the fill value, NaN, where it points outside)."""
    if not use_sequence_length or sequence_length is None:
        return data.flip(axis)
    ln = sequence_length.long()
    pos = torch.arange(data.shape[0], device=data.device)[:, None]
    rev = torch.where(pos < ln[None, :], ln[None, :] - 1 - pos, pos)
    return _ops.take_along_fill(
        data, rev.reshape(tuple(rev.shape) + (1,) * (data.ndim - 2)), 0)


@_arrays
def reshape_like(lhs, rhs):
    """``lhs`` in ``rhs``'s shape."""
    return lhs.reshape(rhs.shape)


@_arrays
def arange_like(data, start=0.0, step=1.0, repeat=1, ctx=None, axis=None):
    """float32 ``arange(start, start + step * n, step)`` with ``n`` the
    size of ``data`` (or of its ``axis``), on ``data``'s device; the
    values are NumPy's (the reference's constant)."""
    n = data.numel() if axis is None else data.shape[axis]
    host = onp.arange(start, start + step * n, step, onp.float32)
    return torch.from_numpy(host).to(data.device)


@_arrays
def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    """``lhs`` broadcast to ``rhs``'s shape."""
    return torch.broadcast_to(lhs, rhs.shape)


@_arrays
def slice(data, begin, end, step=None):  # noqa: A001 - reference name
    """``data[begin[i]:end[i]:step[i]]`` on each leading axis (None keeps
    the axis' end)."""
    step = step or (None,) * len(begin)
    return data[tuple(builtins.slice(b, e, s)
                      for b, e, s in zip(begin, end, step))]


@_arrays
def slice_like(data, shape_like, axes=None):
    """``data`` cut to ``shape_like``'s extent on ``axes`` (every axis by
    default)."""
    key = [builtins.slice(None)] * data.ndim
    for ax in (axes if axes is not None else range(data.ndim)):
        key[ax] = builtins.slice(0, shape_like.shape[ax])
    return data[tuple(key)]


@_arrays
def where(condition, x, y):
    """``x`` where ``condition`` holds, else ``y``."""
    return _ops.where(condition, x, y)


@_arrays
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False,
              forward_stype=None):
    """Batched ``(b, m, k) @ (b, k, n)`` (reference: dot.cc batch_dot)."""
    lhs, rhs = _cast("batch_dot", lhs, rhs)
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


@_arrays
def smooth_l1(data, scalar=1.0):
    """Smooth L1: ``0.5 (s x)^2`` inside ``|x| < 1 / s^2``, else ``|x| -
    0.5 / s^2``."""
    x, = _cast("smooth_l1", data)
    s2 = scalar * scalar
    return torch.where(x.abs() < 1.0 / s2, 0.5 * s2 * x * x,
                       x.abs() - 0.5 / s2)


@_arrays
def softmax_cross_entropy(data, label, sparse_label=True, axis=-1):
    """Sum over the batch of ``-log softmax(data)[label]`` (reference:
    loss_binary_op.cc); the sparse form through the fused op of
    ``ops/xent.py``, the dense form ``-(label * log_softmax).sum()``."""
    from ..ops.xent import sparse_softmax_xent
    if sparse_label:
        return sparse_softmax_xent(data, label, axis).sum()
    data, label = _cast("softmax_cross_entropy", data, label)
    return -(label * torch.log_softmax(data, axis)).sum()


@_arrays
def reshape(data, newshape, reverse=False, order="C"):
    """Reshape with MXNet's codes (reference: np_matrix_op.cc
    ``_npx_reshape``): 0 keeps an axis, -1 infers one, -2 copies the rest,
    -3 merges two axes, -4 splits one into the next two values."""
    shape = list(newshape) if isinstance(newshape, (list, tuple)) \
        else [newshape]
    src = list(data.shape)
    out, si, i = [], 0, 0
    while i < len(shape):
        s = shape[i]
        if s == 0:
            out.append(src[si])
            si += 1
        elif s == -1:
            out.append(-1)
            si += 1
        elif s == -2:
            out.extend(src[si:])
            si = len(src)
        elif s == -3:
            out.append(src[si] * src[si + 1])
            si += 2
        elif s == -4:
            f1, f2 = shape[i + 1], shape[i + 2]
            d = src[si]
            if f1 == -1:
                f1 = d // f2
            if f2 == -1:
                f2 = d // f1
            out.extend([f1, f2])
            si += 1
            i += 2
        else:
            out.append(s)
            si += 1
        i += 1
    return data.reshape(tuple(out))


@_arrays
def split_v2(data, indices_or_sections, axis=0, squeeze_axis=False):
    """``np.split`` with the reference's ``squeeze_axis``."""
    parts = _ops.split(data, indices_or_sections, axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@_arrays
def space_to_depth(data, block_size):
    """(N, C, H, W) -> (N, C*b*b, H/b, W/b) (reference: matrix_op.cc)."""
    b = int(block_size)
    n, c, h, w = data.shape
    if h % b or w % b:
        raise MXNetError(f"H and W must be divisible by block_size {b}, "
                         f"got H={h} W={w}")
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@_arrays
def depth_to_space(data, block_size):
    """The inverse of :func:`space_to_depth`."""
    b = int(block_size)
    n, c, h, w = data.shape
    if c % (b * b):
        raise MXNetError(f"C must be divisible by block_size^2 = {b * b}, "
                         f"got C={c}")
    x = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@_arrays
def shape_array(data):
    """The shape as a 1-d integer array (int32; int64 for a 64-bit input,
    as under the reference's x64 scope)."""
    wide = data.dtype in (torch.int64, torch.float64)
    return torch.tensor(tuple(data.shape), device=data.device,
                        dtype=torch.int64 if wide else torch.int32)


@_arrays
def size_array(data):
    """The element count as a 1-element int32 array."""
    return torch.tensor([data.numel()], dtype=torch.int32,
                        device=data.device)


def nonzero(data):
    """The (N, ndim) int64 indices of the nonzero elements (reference:
    ``_npx_nonzero``). Eager only: the count is read on the host."""
    t = data._data if isinstance(data, ndarray) else torch.as_tensor(data)
    return array(onp.argwhere(t.detach().cpu().numpy()).astype("int64"),
                 device=t.device)


@_arrays
def constraint_check(data, msg="Constraint violated!"):
    """``all(data)``; raises ``ValueError(msg)`` when it is false (a host
    read, as the reference's eager check)."""
    ok = torch.all(data)
    if not bool(ok):
        raise ValueError(msg)
    return ok


@_arrays
def amp_cast(data, dtype=None):
    """Cast a floating input to ``dtype`` (reference: amp_cast.cc); other
    inputs pass unchanged."""
    dt = _dtype(dtype)
    if not data.is_floating_point() or data.dtype == dt:
        return data
    return data.to(dt)


def amp_multicast(*data, num_outputs=None):
    """Every floating input cast to the widest floating dtype among them
    (reference: amp_multicast)."""
    widest = None
    for d in data:
        t = d._data if isinstance(d, ndarray) else d
        if not t.is_floating_point():
            continue
        if widest is None or t.dtype.itemsize > widest.itemsize:
            widest = t.dtype
    if widest is None:
        return tuple(data)
    return tuple(amp_cast(d, dtype=widest) for d in data)


def savez(file, *args, **kwargs):
    """Save arrays to ``.npz``: positional ones as ``arr_0``..., keyword
    ones by name (reference: numpy_extension/utils.py savez)."""
    merged = {f"arr_{i}": a for i, a in enumerate(args)}
    clash = sorted(set(merged) & set(kwargs))
    if clash:
        raise MXNetError(f"cannot use un-named arrays with keyword(s) "
                         f"{clash}; rename the keyword or name every array")
    merged.update(kwargs)
    save(file, merged)


# ---------------------------------------------------------------------------
# the attention entry (reference: src/operator/contrib/transformer.cc)
# ---------------------------------------------------------------------------

def _heads(x, batch, heads, dim, parts, part):
    """(seq, batch, heads*parts*dim) interleaved -> (batch*heads, seq,
    dim) of ``part``."""
    seq = x.shape[0]
    y = x.reshape(seq, batch, heads, parts, dim)[..., part, :]
    return y.permute(1, 2, 0, 3).reshape(batch * heads, seq, dim)


@_arrays
def interleaved_matmul_selfatt_qk(queries_keys_values, heads):
    """``Q K^T / sqrt(dim)`` from interleaved (seq, batch, 3*heads*dim)
    rows -> (batch*heads, seq, seq)."""
    qkv, = _cast("interleaved_matmul_selfatt_qk", queries_keys_values)
    seq, batch, three_hd = qkv.shape
    dim = three_hd // (3 * heads)
    q = _heads(qkv, batch, heads, dim, 3, 0)
    k = _heads(qkv, batch, heads, dim, 3, 1)
    return torch.bmm(q, k.transpose(1, 2)) / math.sqrt(dim)


@_arrays
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention, heads):
    """``att @ V`` back to (seq, batch, heads*dim)."""
    qkv, att = _cast("interleaved_matmul_selfatt_valatt",
                     queries_keys_values, attention)
    seq, batch, three_hd = qkv.shape
    dim = three_hd // (3 * heads)
    out = torch.bmm(att, _heads(qkv, batch, heads, dim, 3, 2))
    return out.reshape(batch, heads, seq, dim).permute(2, 0, 1, 3) \
        .reshape(seq, batch, heads * dim)


@_arrays
def interleaved_matmul_encdec_qk(queries, keys_values, heads):
    """``Q K^T / sqrt(dim)`` of (qlen, batch, heads*dim) queries against
    interleaved (klen, batch, 2*heads*dim) keys and values."""
    q, kv = _cast("interleaved_matmul_encdec_qk", queries, keys_values)
    qlen, batch, hd = q.shape
    dim = hd // heads
    qh = _heads(q, batch, heads, dim, 1, 0)
    k = _heads(kv, batch, heads, dim, 2, 0)
    return torch.bmm(qh, k.transpose(1, 2)) / math.sqrt(dim)


@_arrays
def interleaved_matmul_encdec_valatt(keys_values, attention, heads):
    """``att @ V`` of the interleaved keys and values, back to (qlen,
    batch, heads*dim)."""
    kv, att = _cast("interleaved_matmul_encdec_valatt", keys_values,
                    attention)
    klen, batch, two_hd = kv.shape
    dim = two_hd // (2 * heads)
    out = torch.bmm(att, _heads(kv, batch, heads, dim, 2, 1))
    qlen = att.shape[1]
    return out.reshape(batch, heads, qlen, dim).permute(2, 0, 1, 3) \
        .reshape(qlen, batch, heads * dim)


@_arrays
def multi_head_attention(query, key, value, heads, mask=None, dropout_p=0.0,
                         causal=False, generator=None):
    """Batch-first attention on (batch, seq, heads*dim):
    ``ops/attention.py`` ``multi_head_attention``, which takes the flash
    kernels (kernels 1-3 on the card) without a mask or live dropout."""
    from ..ops.attention import multi_head_attention as op
    return op(query, key, value, heads, mask=mask, dropout_p=dropout_p,
              causal=causal, generator=generator)


# ---------------------------------------------------------------------------
# the fused RNN (reference: src/operator/rnn-inl.h)
# ---------------------------------------------------------------------------

@_arrays
def rnn(data=None, parameters=None, state=None, state_cell=None,
        mode="lstm", state_size=None, num_layers=1, bidirectional=False,
        p=0.0, state_outputs=True, projection_size=None,
        lstm_state_clip_min=None, lstm_state_clip_max=None,
        lstm_state_clip_nan=False, use_sequence_length=False,
        sequence_length=None):
    """Fused multi-layer RNN over (seq, batch, input) ``data`` with the
    flat ``parameters`` packed as the reference packs them (every
    ``[Wx, Wh]`` layer-major, then every ``[bx, bh]``): ``ops/rnn.py``,
    cuDNN's RNN on the card where the route takes the call, else the loop
    over time. Returns ``(out, hT[, cT])``, or ``out`` without
    ``state_outputs``. As in the reference, ``p``, ``projection_size``,
    ``use_sequence_length`` and ``lstm_state_clip_nan`` are accepted and
    read nowhere; the LSTM state clip applies when
    ``lstm_state_clip_min`` is given."""
    from ..ops import rnn as _rnn
    weights = _rnn.unpack(parameters, mode, state_size, num_layers,
                          bidirectional, data.shape[-1])
    out, h, c = _rnn.rnn(data, weights, state,
                         state_cell if mode == "lstm" else None, mode,
                         num_layers, bidirectional, lstm_state_clip_min,
                         lstm_state_clip_max)
    if not state_outputs:
        return out
    return (out, h, c) if mode == "lstm" else (out, h)


# ---------------------------------------------------------------------------
# control flow (reference: src/operator/npx_control_flow.cc)
# ---------------------------------------------------------------------------

def _stack(items, axis=0):
    """Stack a list of arrays (``ndarray``s or tensors) along a new
    ``axis``."""
    if type(items[0]) is ndarray:
        from .. import numpy as _np
        return _np.stack(items, axis=axis)
    return torch.stack(items, dim=axis)


def _empty_outputs(body, data, init_states, single_data):
    """The (0, ...) outputs of a length-0 ``foreach``: the body's output
    shapes from one untracked call on zeros, as the reference's scan
    traces its body for them."""
    def zero_slice(d):
        t = d._data if type(d) is ndarray else d
        z = torch.zeros(tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        return _wrap(z) if type(d) is ndarray else z

    x0 = zero_slice(data) if single_data else [zero_slice(d) for d in data]
    with torch.no_grad():
        out, _ = body(x0, init_states)

    def empty(o):
        t = o._data if type(o) is ndarray else o
        e = t.new_zeros((0,) + tuple(t.shape))
        return _wrap(e) if type(o) is ndarray else e
    if isinstance(out, (list, tuple)):
        return [empty(o) for o in out]
    return empty(out)


def foreach(body, data, init_states):
    """Run ``body(data[t], states) -> (out, states)`` over axis 0 of
    ``data`` (an array or a list of arrays) and stack the outputs
    (reference: ``npx.foreach``). The loop runs step by step, so under
    ``autograd.record()`` gradients reach the data, the states and the
    parameters the body closes over. A length-0 loop returns (0, ...)
    outputs and the initial states."""
    single_data = isinstance(data, (ndarray, torch.Tensor))
    length = data.shape[0] if single_data else data[0].shape[0]
    if length == 0:
        return _empty_outputs(body, data, init_states, single_data), \
            init_states
    states = init_states
    outs = []
    for t in range(length):
        x_t = data[t] if single_data else [d[t] for d in data]
        out, states = body(x_t, states)
        outs.append(out)
    if isinstance(outs[0], (list, tuple)):
        return [_stack([o[i] for o in outs])
                for i in range(len(outs[0]))], states
    return _stack(outs), states


def while_loop(cond, func, loop_vars, max_iterations=None):
    """``func(*vars) -> (out, vars)`` while ``cond(*vars)`` holds, at most
    ``max_iterations`` times; returns the stacked outputs and the final
    variables (reference: ``npx.while_loop``; the condition is read on the
    host each step)."""
    steps = 0
    outputs = []
    vars_ = list(loop_vars)
    while bool(cond(*vars_)) and (max_iterations is None
                                  or steps < max_iterations):
        out, vars_ = func(*vars_)
        outputs.append(out)
        vars_ = list(vars_) if isinstance(vars_, (list, tuple)) else [vars_]
        steps += 1
    if outputs and isinstance(outputs[0], (ndarray, torch.Tensor)):
        return _stack(outputs), vars_
    return outputs, vars_


def cond(pred, then_func, else_func, inputs=None):
    """``then_func(*inputs)`` if ``pred`` (a value, or a callable of the
    inputs) holds, else ``else_func(*inputs)`` (reference: ``npx.cond``;
    the predicate is read on the host)."""
    inputs = [] if inputs is None else inputs
    if bool(pred(*inputs) if callable(pred) else pred):
        return then_func(*inputs)
    return else_func(*inputs)


# ---------------------------------------------------------------------------
# state, devices and the extension samplers
# ---------------------------------------------------------------------------

_np_state = {"active": True}


def set_np(shape=True, array=True, dtype=False):
    """NumPy semantics on (reference: ``npx.set_np``); the port has no
    other semantics, so this records the switch only."""
    _np_state["active"] = True


def reset_np():
    """NumPy semantics "off": recorded only, as :func:`set_np`."""
    _np_state["active"] = False


def is_np_array():
    return True


def is_np_shape():
    return True


def is_np_default_dtype():
    return False


def use_np(func):
    return func


use_np_array = use_np_shape = use_np


def seed(seed, ctx="all"):  # noqa: A002 - reference name
    """Seed the default generators (``mx.random.seed``)."""
    from .. import random as _random
    _random.seed(seed)


def bernoulli(prob=None, logit=None, size=None, dtype=None, ctx=None,
              out=None, device=None, generator=None):
    """0/1 samples from probabilities or logits, exactly one given
    (reference: numpy_extension/random.py), in ``dtype`` (float32 by
    default), of ``size`` or the parameter's shape; from ``generator`` or
    the default generator of the device."""
    from ..numpy import random as _r
    if (prob is None) == (logit is None):
        raise MXNetError("pass exactly one of prob or logit")
    param = prob if logit is None else logit
    dev = _r._device(ctx, device, param)
    p = _r._param(param, dev, torch.float32)
    p = torch.as_tensor(p, dtype=torch.float32, device=dev)
    if logit is not None:
        p = torch.sigmoid(p)
    shape = tuple(p.shape) if size is None else _r._shape(size)
    u = torch.rand(shape, generator=_r._gen(dev, generator), device=dev)
    res = _wrap((u < p).to(_dtype(dtype) or torch.float32))
    return _writeback(out, res)


def _sample_n(draw, a, b, batch_shape, dtype, ctx, device, generator):
    """Samples of shape ``batch_shape + broadcast(a, b).shape``."""
    from ..numpy import random as _r
    dev = _r._device(ctx, device, a, b)
    a = torch.as_tensor(_r._param(a, dev, torch.float32), device=dev)
    b = torch.as_tensor(_r._param(b, dev, torch.float32), device=dev)
    shape = _r._shape(batch_shape) if batch_shape is not None else ()
    shape += tuple(torch.broadcast_shapes(a.shape, b.shape))
    s = draw(shape, dev, _r._gen(dev, generator), a, b)
    return _wrap(s.to(_dtype(dtype) or torch.float32))


def uniform_n(low=0.0, high=1.0, batch_shape=None, dtype=None, ctx=None,
              device=None, generator=None):
    """Uniform samples of shape ``batch_shape + broadcast(low,
    high).shape`` (reference: numpy_extension/random.py)."""
    return _sample_n(
        lambda shape, dev, gen, lo, hi:
            lo + torch.rand(shape, generator=gen, device=dev) * (hi - lo),
        low, high, batch_shape, dtype, ctx, device, generator)


def normal_n(loc=0.0, scale=1.0, batch_shape=None, dtype=None, ctx=None,
             device=None, generator=None):
    """Normal samples of shape ``batch_shape + broadcast(loc,
    scale).shape`` (reference: numpy_extension/random.py)."""
    return _sample_n(
        lambda shape, dev, gen, mu, sigma:
            mu + sigma * torch.randn(shape, generator=gen, device=dev),
        loc, scale, batch_shape, dtype, ctx, device, generator)


box_iou = _arrays(_bbox.box_iou)
box_nms = _arrays(_bbox.box_nms)
box_encode = _arrays(_bbox.box_encode)
box_decode = _arrays(_bbox.box_decode)
bipartite_matching = _arrays(_bbox.bipartite_matching)
multibox_prior = _arrays(_multibox.multibox_prior)
multibox_target = _arrays(_multibox.multibox_target)
multibox_detection = _arrays(_multibox.multibox_detection)


_PLAIN = {name: globals()[name].__wrapped__ for name in __all__
          if hasattr(globals().get(name), "__wrapped__")}


def _hooked(fn):
    def op(*args, **kwargs):
        return _hooks.call(fn, _ref_name(fn, args, kwargs), args, kwargs)
    op.__name__ = op.__qualname__ = fn.__name__
    op.__wrapped__ = fn
    return op


_HOOKED = {name: _hooked(fn) for name, fn in _PLAIN.items()}

#: the ops over tensors, as the layers and the model zoo call them: the
#: undecorated functions while every host plane is off, their hooked
#: versions while one is on (:func:`_set_hooked`)
tensor_ops = types.SimpleNamespace(**_PLAIN)


def _set_hooked(on):
    for name, fn in (_HOOKED if on else _PLAIN).items():
        setattr(tensor_ops, name, fn)


_hooks.register(_set_hooked)

# at the end: amp imports ops.quant_matmul (through amp.fp8), which reads
# this module's _ACTS
from .. import amp as _amp  # noqa: E402
from . import image  # noqa: E402,F401
from . import random  # noqa: E402,F401


def __getattr__(name):
    # gluon.utils' own function (gluon imports this module first)
    if name == "clip_global_norm":
        from ..gluon.utils import clip_global_norm
        return clip_global_norm
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
