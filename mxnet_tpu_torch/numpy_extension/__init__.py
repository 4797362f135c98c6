"""The ``npx`` operators on the ported paths, as plain PyTorch.

Counterpart of ``mxnet_tpu/numpy_extension/__init__.py`` (fully_connected,
convolution, deconvolution, (modulated_)deformable_convolution, pooling,
batch_norm, fused_conv_bn_relu, flatten, layer_norm, group_norm,
instance_norm, dropout, activation, leaky_relu (leaky, prelu, elu, selu,
gelu, rrelu), gelu, embedding, and from
``ops/quantization.py`` ``quantize_v2``, ``dequantize``,
``quantized_fully_connected``, ``quantized_conv``,
``quantized_dense_fused``, ``quantized_conv_fused`` and
``fp8_dense_fused``, imported at the call: the ops import this module's
activation table); the rest of that module waits for later slices of the
port.

Each op that the JAX package dispatches under a name passes its floating
inputs through ``amp._maybe_cast_op_inputs`` under that name (the AMP
policy, off unless ``amp.init()`` ran): ``fully_connected``,
``convolution``, ``pooling:<pool_type>``, ``batch_norm``,
``fused_conv_bn_relu``, ``layer_norm``, ``softmax``,
``activation:<act_type>``, ``leaky_relu:<act_type>`` (``gelu`` is the
reference's ``leaky_relu`` with act_type "gelu") and ``embedding``.
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
``sparse_grad``, which raises until sparse storage is ported; the "sum"
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

import functools
import inspect
import math
import types

import numpy as onp
import torch
import torch.nn.functional as F

from .. import _hooks
from ..base import MXNetError
from ..numpy.multiarray import _invoke_impl, array, ndarray

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
           "load"]


#: the reference's ``_invoke`` name of each op (a str, or the argument
#: whose value follows a prefix), for the host planes' hooks; the AMP
#: policy is the op's own (each op casts its inputs by that name)
_REF_NAMES = {
    "pooling": ("pooling:", "pool_type"),
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
    prefix, arg = name
    bound = _signature(fn).bind(*args, **kwargs)
    bound.apply_defaults()
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
    The normalization is the folded per-channel ``x * scale + shift``."""
    from .. import autograd
    x, gamma, beta = _cast("batch_norm", x, gamma, beta)
    training = autograd.is_training() and not use_global_stats
    red = tuple(i for i in range(x.ndim) if i != axis)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    if training:
        xf = x.to(acc)
        mean = xf.mean(dim=red)
        var = torch.clamp((xf * xf).mean(dim=red) - mean * mean, min=0.0)
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
    device. ``sparse_grad=True`` (a row-sparse gradient) raises until
    sparse storage is ported (ROADMAP.md Queue 1, item 9)."""
    if sparse_grad:
        raise MXNetError("embedding(sparse_grad=True): row-sparse gradients "
                         "are not ported yet (ROADMAP.md Queue 1, item 9)")
    weight, = _cast("embedding", weight)
    v = weight.shape[0]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + v, idx)
    bad = (idx < 0) | (idx >= v)
    out = F.embedding(idx.clamp(0, max(v - 1, 0)), weight)
    return out.masked_fill(bad.unsqueeze(-1), float("nan"))


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
    key = [slice(None)] * data.ndim
    key[axis] = slice(begin, end)
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


_PLAIN = {name: globals()[name].__wrapped__ for name in __all__
          if hasattr(globals()[name], "__wrapped__")}


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
