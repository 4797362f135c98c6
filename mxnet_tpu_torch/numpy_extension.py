"""The ``npx`` operators on the ported paths, as plain PyTorch.

Counterpart of ``mxnet_tpu/numpy_extension/__init__.py`` (fully_connected,
convolution, pooling, batch_norm, fused_conv_bn_relu, flatten, layer_norm,
activation, leaky_relu, exact-erf gelu, embedding, and from
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

``batch_norm`` and ``fused_conv_bn_relu`` update the running statistics in
place while training, as the reference's aux arrays are: ``m * running +
(1 - m) * batch`` under ``torch.no_grad()``, so the update is never part
of a recorded graph.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from .base import MXNetError

__all__ = ["fully_connected", "convolution", "pooling", "batch_norm",
           "fused_conv_bn_relu", "flatten", "layer_norm", "softmax",
           "activation",
           "leaky_relu", "gelu", "embedding", "quantize_v2", "dequantize",
           "quantized_fully_connected", "quantized_conv",
           "quantized_dense_fused", "quantized_conv_fused",
           "fp8_dense_fused"]

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


def fully_connected(x, weight, bias=None, flatten=True):
    """``x @ weight.T + bias`` with weight layout (units, in_units)
    (reference: src/operator/nn/fully_connected.cc), in the inputs' common
    dtype (bf16 x with fp32 weight runs in fp32, as in the reference): the
    product in x's and weight's, then the bias added with promotion."""
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


def pooling(data, kernel=1, stride=None, pad=None, pool_type="max",
            pooling_convention="valid", global_pool=False, p_value=2,
            count_include_pad=True, layout="NCHW", cudnn_off=False):
    """Max and avg pooling, windowed or global (reference: pooling.cc): max
    pads with -inf, avg with zeros and divides by the window
    (``count_include_pad``) or by its valid elements."""
    nd = data.ndim - 2
    _channel_first(layout, nd)
    data, = _cast(f"pooling:{pool_type}", data)
    if pool_type not in ("max", "avg"):
        raise MXNetError(f"pool_type {pool_type!r} is not part of this "
                         "slice of the port")
    if pooling_convention != "valid":
        raise MXNetError("only pooling_convention='valid' is part of this "
                         "slice of the port")
    spatial = tuple(range(2, data.ndim))
    if global_pool:
        if pool_type == "max":
            return data.amax(dim=spatial, keepdim=True)
        return data.mean(dim=spatial, keepdim=True)
    kernel = (kernel,) * nd if isinstance(kernel, int) else tuple(kernel)
    stride = tuple(stride) if stride else kernel
    pads = _spatial_pad(tuple(pad) if pad else (0,) * nd)
    if pool_type == "max":
        return _MAX_POOL[nd](F.pad(data, pads, value=-math.inf), kernel,
                             stride)
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


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False):
    """Batch normalization over ``axis`` (reference: batch_norm.cc, as the
    JAX package computes it). Training (``autograd.is_training()`` and not
    ``use_global_stats``): single-pass fp32 statistics ``E[x^2] - E[x]^2``
    (fp64 for fp64 inputs, as the fused route's) clamped at 0, and the
    running statistics updated in place; otherwise the running statistics.
    The normalization is the folded per-channel ``x * scale + shift``."""
    from . import autograd
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


def fused_conv_bn_relu(x, weight, gamma, beta, running_mean, running_var,
                       momentum=0.9, eps=1e-5):
    """Training-mode ``relu(bn(conv3x3_s1(x, w)))`` whose backward is
    kernel 8 (``ops/conv_bwd.py``: the CUDA kernel for a CUDA tensor, its
    plain version for a CPU tensor). NCHW in and out, weight OIHW; the
    running statistics update as :func:`batch_norm`'s do, from the
    two-pass batch statistics of the fused forward."""
    from .ops.conv_bwd import FusedCBRFunction
    x, weight, gamma, beta = _cast("fused_conv_bn_relu", x, weight, gamma,
                                   beta)
    out, mean, var = FusedCBRFunction.apply(x, weight, gamma, beta,
                                            float(eps))
    _update_running(running_mean, running_var, mean, var, momentum)
    return out


def flatten(x):
    """(N, ...) -> (N, prod(...)) (reference: npx.flatten)."""
    return x.reshape(x.shape[0], -1)


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis (reference: layer_norm.cc), returning
    the common dtype of x, gamma and beta. An fp32 or fp64 x takes
    ``F.layer_norm``; a bf16 or fp16 x is normalized in its own dtype, as
    the reference's jnp computes it: the statistics in fp32 and rounded to
    x's dtype, then ``(x - mean) * rsqrt(var + eps)`` in x's dtype (each
    step rounded), then the affine in the common dtype (fp32 for fp32
    gamma)."""
    x, gamma, beta = _cast("layer_norm", x, gamma, beta)
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


def softmax(data, axis=-1, temperature=None, dtype=None):
    """Softmax along ``axis`` (reference: softmax.cc), in the input's dtype
    unless ``dtype`` is given; fp32 under the AMP policy."""
    data, = _cast("softmax", data)
    h = data / temperature if temperature else data
    return torch.softmax(h, dim=axis).to(dtype or data.dtype)


def activation(data, act_type="relu"):
    """Reference: src/operator/nn/activation.cc."""
    if act_type not in _ACTS:
        raise MXNetError(f"unknown act_type {act_type!r}")
    data, = _cast(f"activation:{act_type}", data)
    return _ACTS[act_type](data)


def leaky_relu(data, act_type="leaky", slope=0.25):
    """Reference: src/operator/leaky_relu.cc, the ``leaky``, ``elu``
    (alpha ``slope``), ``selu`` and ``gelu`` (exact erf) act types; the
    others wait for a later slice. ``elu`` and ``selu`` are fp32 under the
    AMP policy (conditional fp32 entries)."""
    if act_type == "gelu":
        return gelu(data)
    data, = _cast(f"leaky_relu:{act_type}", data)
    if act_type == "leaky":
        return F.leaky_relu(data, slope)
    if act_type == "elu":
        return F.elu(data, slope)
    if act_type == "selu":
        return F.selu(data)
    raise MXNetError(f"leaky_relu act_type {act_type!r} is not part of "
                     "this slice of the port")


def gelu(x):
    """Exact (erf) GELU, as ``npx.leaky_relu(act_type="gelu")`` computes
    it (``approximate=False``), dispatched under its name there."""
    x, = _cast("leaky_relu:gelu", x)
    return F.gelu(x, approximate="none")


def embedding(ids, weight):
    """Row gather ``weight[ids]`` (reference: indexing_op.cc Embedding), with
    the reference's ``jnp.take`` rule for ids out of range: an id in
    [-V, 0) wraps from the end, any other out-of-range id gives a row of
    NaN whose gradient reaches no weight row. Float ids truncate. The rule
    is decided from the ids' values before the gather (a clamped id is
    gathered and its row overwritten), so no index check fires on the
    device."""
    weight, = _cast("embedding", weight)
    v = weight.shape[0]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + v, idx)
    bad = (idx < 0) | (idx >= v)
    out = F.embedding(idx.clamp(0, max(v - 1, 0)), weight)
    return out.masked_fill(bad.unsqueeze(-1), float("nan"))


def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """float32 -> (int8, min_range, max_range): see
    :func:`mxnet_tpu_torch.ops.quantization.quantize_v2`."""
    from .ops.quantization import quantize_v2 as op
    return op(data, min_calib_range, max_calib_range, out_type)


def dequantize(data, min_range, max_range, out_type="float32"):
    """int8 -> float32: see :func:`mxnet_tpu_torch.ops.quantization.
    dequantize`."""
    from .ops.quantization import dequantize as op
    return op(data, min_range, max_range, out_type)


def quantized_fully_connected(data, weight, x_scale, w_scale, bias=None,
                              flatten=True):
    """int8 x int8 -> fp32 dense layer: see :func:`mxnet_tpu_torch.ops.
    quantization.quantized_fully_connected`."""
    from .ops.quantization import quantized_fully_connected as op
    return op(data, weight, x_scale, w_scale, bias=bias, flatten=flatten)


def quantized_conv(data, weight, x_scale, w_scale, bias=None, kernel=None,
                   stride=None, dilate=None, pad=None, num_filter=1,
                   num_group=1, layout="NCHW"):
    """int8 x int8 -> fp32 convolution: see :func:`mxnet_tpu_torch.ops.
    quantization.quantized_conv`."""
    from .ops.quantization import quantized_conv as op
    return op(data, weight, x_scale, w_scale, bias=bias, kernel=kernel,
              stride=stride, dilate=dilate, pad=pad, num_filter=num_filter,
              num_group=num_group, layout=layout)


def quantized_conv_fused(data, weight, x_scale, w_scale, bias=None, act=None,
                         kernel=None, stride=None, dilate=None, pad=None,
                         num_filter=1, num_group=1, layout="NCHW"):
    """Fused quantize -> int8 conv -> dequant + bias + act: see
    :func:`mxnet_tpu_torch.ops.quantization.quantized_conv_fused`."""
    from .ops.quantization import quantized_conv_fused as op
    return op(data, weight, x_scale, w_scale, bias=bias, act=act,
              kernel=kernel, stride=stride, dilate=dilate, pad=pad,
              num_filter=num_filter, num_group=num_group, layout=layout)


def quantized_dense_fused(data, weight, x_scale, w_scale, bias=None,
                          act=None, flatten=True):
    """int8 dense layer with a fused epilogue (kernel 6 on the card): see
    :func:`mxnet_tpu_torch.ops.quantization.quantized_dense_fused`."""
    from .ops.quantization import quantized_dense_fused as op
    return op(data, weight, x_scale, w_scale, bias=bias, act=act,
              flatten=flatten)


def fp8_dense_fused(data, weight, x_scale, w_scale, bias=None, act=None,
                    flatten=True, fmt=None):
    """fp8-activation dense layer with a fused epilogue: see
    :func:`mxnet_tpu_torch.ops.quantization.fp8_dense_fused`."""
    from .ops.quantization import fp8_dense_fused as op
    return op(data, weight, x_scale, w_scale, bias=bias, act=act,
              flatten=flatten, fmt=fmt)


# at the end: amp imports ops.quant_matmul (through amp.fp8), which reads
# this module's _ACTS
from . import amp as _amp  # noqa: E402
