"""The legacy CamelCase operator table of ``mx.nd``.

Counterpart of ``mxnet_tpu/ndarray/register.py`` (reference parity: the
1.x generated wrappers, python/mxnet/ndarray/register.py:115-277, one
function per registered op, including the CamelCase layer ops that 1.x
scripts and serialized symbol graphs use). One table, :data:`LEGACY_OPS`,
maps each legacy name and its legacy keyword arguments (``num_hidden``,
``no_bias``, ``kernel``, ...) onto the port's ``mx.np`` / ``npx``
functions; ``mx.nd.__getattr__`` consults it first, and a Symbol will
consult the same table. Every adapter parses string attributes as 1.x
JSON stores them (``kernel="(3, 3)"``, ``no_bias="True"``).

The ops the reference writes inline in JAX are written here in torch,
in the reference's arithmetic: the ``*Output`` loss layers and
``MakeLoss`` (a ``torch.autograd.Function`` each whose backward ignores
the head gradient, as the reference's ``custom_vjp``), ``LRN``,
``ROIPooling``, ``UpSampling``, the ``linalg_*`` family,
``BilinearSampler`` / ``GridGenerator`` / ``SpatialTransformer``. Arrays
in, arrays out (``numpy.multiarray._invoke``); ``out=`` writes through
(:func:`with_out`).
"""
from __future__ import annotations

import ast
import functools

import torch
import torch.nn.functional as F

from ..base import MXNetError

LEGACY_OPS: dict = {}


def register(name):
    def deco(fn):
        fn.__name__ = name
        LEGACY_OPS[name] = fn
        return fn
    return deco


_OUT_WRAPPED: dict = {}


def with_out(fn):
    """``fn`` with ``out=`` written through to the destination array (the
    reference's generated-wrapper semantics, ndarray/register.py:171)."""
    w = _OUT_WRAPPED.get(fn)
    if w is None:
        @functools.wraps(fn)
        def w(*args, **kwargs):
            out = kwargs.pop("out", None)
            res = fn(*args, **kwargs)
            if out is None:
                return res
            from ..numpy.multiarray import _writeback
            return _writeback(out, res)
        _OUT_WRAPPED[fn] = w
    return w


def get(name):
    fn = LEGACY_OPS.get(name)
    return None if fn is None else with_out(fn)


def _invoke(fn, args, name):
    from ..numpy.multiarray import _invoke as inv
    return inv(fn, args, name=name)


# -- legacy attribute parsing -------------------------------------------------------

def _lit(v):
    """A legacy string attribute parsed: "(3, 3)" -> (3, 3), "True" ->
    True, "2" -> 2; anything else as it is."""
    if isinstance(v, str):
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v
    return v


def _tup(v, n=None):
    v = _lit(v)
    if v is None:
        return None
    if isinstance(v, int):
        return (v,) * (n or 1)
    return tuple(v)


def _b(v):
    v = _lit(v)
    if isinstance(v, str):
        return v.lower() in ("true", "1")
    return bool(v)


def _drop_name(kw):
    kw.pop("name", None)
    kw.pop("ctx", None)
    return kw


def _npx():
    from .. import numpy_extension as npx
    return npx


def _np():
    from .. import numpy as np
    return np


# -- neural-network layers ------------------------------------------------------------

@register("FullyConnected")
def _fully_connected(data, weight=None, bias=None, num_hidden=None,
                     no_bias=False, flatten=True, **kw):
    _drop_name(kw)
    return _npx().fully_connected(data, weight, bias,
                                  num_hidden=int(_lit(num_hidden)),
                                  no_bias=_b(no_bias), flatten=_b(flatten))


@register("Convolution")
def _convolution(data, weight=None, bias=None, kernel=None, stride=None,
                 dilate=None, pad=None, num_filter=1, num_group=1,
                 workspace=1024, no_bias=False, layout=None, **kw):
    _drop_name(kw)
    kernel = _tup(kernel)
    n = len(kernel)
    return _npx().convolution(data, weight, bias, kernel=kernel,
                              stride=_tup(stride, n), dilate=_tup(dilate, n),
                              pad=_tup(pad, n),
                              num_filter=int(_lit(num_filter)),
                              num_group=int(_lit(num_group)),
                              no_bias=_b(no_bias), layout=_lit(layout))


@register("Deconvolution")
def _deconvolution(data, weight=None, bias=None, kernel=None, stride=None,
                   dilate=None, pad=None, adj=None, target_shape=None,
                   num_filter=1, num_group=1, workspace=512, no_bias=True,
                   layout=None, **kw):
    _drop_name(kw)
    kernel = _tup(kernel)
    n = len(kernel)
    return _npx().deconvolution(data, weight, bias, kernel=kernel,
                                stride=_tup(stride, n),
                                dilate=_tup(dilate, n), pad=_tup(pad, n),
                                adj=_tup(adj, n),
                                num_filter=int(_lit(num_filter)),
                                num_group=int(_lit(num_group)),
                                no_bias=_b(no_bias), layout=_lit(layout))


@register("BatchNorm")
def _batch_norm(data, gamma=None, beta=None, moving_mean=None,
                moving_var=None, eps=1e-3, momentum=0.9, fix_gamma=True,
                use_global_stats=False, output_mean_var=False, axis=1, **kw):
    _drop_name(kw)
    return _npx().batch_norm(data, gamma, beta, moving_mean, moving_var,
                             eps=float(_lit(eps)),
                             momentum=float(_lit(momentum)),
                             fix_gamma=_b(fix_gamma),
                             use_global_stats=_b(use_global_stats),
                             output_mean_var=_b(output_mean_var),
                             axis=int(_lit(axis)))


@register("LayerNorm")
def _layer_norm(data, gamma=None, beta=None, axis=-1, eps=1e-5, **kw):
    _drop_name(kw)
    return _npx().layer_norm(data, gamma, beta, axis=int(_lit(axis)),
                             eps=float(_lit(eps)))


@register("GroupNorm")
def _group_norm(data, gamma=None, beta=None, num_groups=1, eps=1e-5, **kw):
    _drop_name(kw)
    return _npx().group_norm(data, gamma, beta,
                             num_groups=int(_lit(num_groups)),
                             eps=float(_lit(eps)))


@register("InstanceNorm")
def _instance_norm(data, gamma=None, beta=None, eps=1e-3, **kw):
    _drop_name(kw)
    return _npx().instance_norm(data, gamma, beta, eps=float(_lit(eps)))


@register("L2Normalization")
def _l2_normalization(data, eps=1e-10, mode="instance", **kw):
    _drop_name(kw)
    return _npx().l2_normalization(data, eps=float(_lit(eps)),
                                   mode=_lit(mode))


@register("Activation")
def _activation(data, act_type="relu", **kw):
    _drop_name(kw)
    return _npx().activation(data, act_type=_lit(act_type))


@register("LeakyReLU")
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334, **kw):
    _drop_name(kw)
    return _npx().leaky_relu(data, gamma, act_type=_lit(act_type),
                             slope=float(_lit(slope)),
                             lower_bound=float(_lit(lower_bound)),
                             upper_bound=float(_lit(upper_bound)))


@register("Pooling")
def _pooling(data, kernel=1, stride=None, pad=None, pool_type="max",
             pooling_convention="valid", global_pool=False, p_value=2,
             count_include_pad=True, layout=None, **kw):
    _drop_name(kw)
    n = data.ndim - 2
    return _npx().pooling(data, kernel=_tup(kernel, n),
                          stride=_tup(stride, n), pad=_tup(pad, n),
                          pool_type=_lit(pool_type),
                          pooling_convention=_lit(pooling_convention),
                          global_pool=_b(global_pool),
                          p_value=int(_lit(p_value)),
                          count_include_pad=_b(count_include_pad),
                          layout=_lit(layout) if layout
                          else {1: "NCW", 2: "NCHW", 3: "NCDHW"}[n])


@register("Dropout")
def _dropout(data, p=0.5, mode="training", axes=None, **kw):
    _drop_name(kw)
    return _npx().dropout(data, p=float(_lit(p)), mode=_lit(mode),
                          axes=_tup(axes) if axes else ())


@register("Embedding")
def _embedding(data, weight=None, input_dim=None, output_dim=None,
               dtype="float32", sparse_grad=False, **kw):
    _drop_name(kw)
    return _npx().embedding(data, weight, input_dim=int(_lit(input_dim)),
                            output_dim=int(_lit(output_dim)),
                            sparse_grad=_b(sparse_grad))


@register("RNN")
def _rnn(data, parameters=None, state=None, state_cell=None, mode="lstm",
         state_size=None, num_layers=1, bidirectional=False, p=0.0,
         state_outputs=False, projection_size=None, sequence_length=None,
         use_sequence_length=False, **kw):
    _drop_name(kw)
    return _npx().rnn(data=data, parameters=parameters, state=state,
                      state_cell=state_cell, mode=_lit(mode),
                      state_size=int(_lit(state_size)),
                      num_layers=int(_lit(num_layers)),
                      bidirectional=_b(bidirectional), p=float(_lit(p)),
                      state_outputs=_b(state_outputs),
                      projection_size=(int(_lit(projection_size))
                                       if projection_size else None),
                      use_sequence_length=_b(use_sequence_length),
                      sequence_length=sequence_length)


# -- shape and data movement --------------------------------------------------------

@register("Reshape")
def _reshape(data, shape=None, reverse=False, target_shape=None,
             keep_highest=False, **kw):
    _drop_name(kw)
    if shape is None and target_shape is not None:
        # pre-1.0 attribute: the exact output shape, 0 keeps the input's
        # axis (keep_highest keeps axis 0)
        tgt = _tup(target_shape)
        out = tuple(data.shape[i] if (s == 0 or (_b(keep_highest) and i == 0))
                    else s for i, s in enumerate(tgt))
        return data.reshape(out)
    if shape is None:
        raise MXNetError("Reshape requires shape or target_shape")
    return _npx().reshape(data, _tup(shape), reverse=_b(reverse))


@register("Flatten")
def _flatten(data, **kw):
    _drop_name(kw)
    return data.reshape((data.shape[0], -1))


@register("Concat")
def _concat(*data, dim=1, num_args=None, **kw):
    _drop_name(kw)
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        data = tuple(data[0])
    return _np().concatenate(data, axis=int(_lit(dim)))


@register("SliceChannel")
def _slice_channel(data, num_outputs=1, axis=1, squeeze_axis=False, **kw):
    _drop_name(kw)
    axis = int(_lit(axis))
    parts = _np().split(data, int(_lit(num_outputs)), axis=axis)
    if _b(squeeze_axis):
        parts = [p.squeeze(axis=axis) for p in parts]
    return parts


@register("SwapAxis")
def _swap_axis(data, dim1=0, dim2=0, **kw):
    _drop_name(kw)
    return _np().swapaxes(data, int(_lit(dim1)), int(_lit(dim2)))


@register("ExpandDims")
def _expand_dims(data, axis=0, **kw):
    _drop_name(kw)
    return _np().expand_dims(data, int(_lit(axis)))


@register("Cast")
def _cast(data, dtype=None, **kw):
    _drop_name(kw)
    return data.astype(_lit(dtype))


@register("Pad")
def _pad(data, mode="constant", pad_width=None, constant_value=0, **kw):
    _drop_name(kw)
    pw = _tup(pad_width)
    pairs = tuple((pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2))
    mode = _lit(mode)
    if mode == "constant":
        return _np().pad(data, pairs, mode="constant",
                         constant_values=float(_lit(constant_value)))
    return _np().pad(data, pairs, mode={"edge": "edge",
                                        "reflect": "reflect"}[mode])


@register("UpSampling")
def _up_sampling(*data, scale=1, sample_type="nearest", num_filter=0,
                 multi_input_mode="concat", num_args=1, **kw):
    _drop_name(kw)
    scale = int(_lit(scale))
    nearest = _lit(sample_type) == "nearest"

    def fn(x):
        if nearest:
            return x.repeat_interleave(scale, 2).repeat_interleave(scale, 3)
        return F.interpolate(x, scale_factor=scale, mode="bilinear",
                             align_corners=False)
    return _invoke(fn, (data[0],), "upsampling")


@register("Crop")
def _crop(*data, offset=(0, 0), h_w=(0, 0), center_crop=False,
          num_args=1, **kw):
    _drop_name(kw)
    x = data[0]
    offset, h_w = _tup(offset, 2), _tup(h_w, 2)
    if len(data) > 1:
        h, w = data[1].shape[2], data[1].shape[3]
    else:
        h, w = h_w
    if _b(center_crop):
        oy, ox = (x.shape[2] - h) // 2, (x.shape[3] - w) // 2
    else:
        oy, ox = offset
    return x[:, :, oy:oy + h, ox:ox + w]


# -- the loss layers: the backward ignores the head gradient --------------------------

class _LossLayer(torch.autograd.Function):
    """A legacy loss layer: ``forward_fn(x)`` forward, ``grad_fn(out, x,
    label)`` as the input's gradient whatever the head gradient (the
    reference's ``custom_vjp`` rules); the label takes no gradient."""

    _first_order_only = True
    _mx_name = "legacy loss layer"

    @staticmethod
    def forward(ctx, x, label, forward_fn, grad_fn):
        out = forward_fn(x)
        ctx.save_for_backward(out, x, label)
        ctx.grad_fn = grad_fn
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        out, x, label = ctx.saved_tensors
        return ctx.grad_fn(out, x, label).to(x.dtype), None, None, None


def _loss_layer(name, data, label, forward_fn, grad_fn):
    def fn(x, lab):
        if lab is None:
            lab = x.new_zeros(())
        return _LossLayer.apply(x, lab, forward_fn, grad_fn)
    return _invoke(fn, (data, label), name)


def _one_hot(lab, n, axis, dtype):
    """One-hot of integer labels along ``axis``; a label outside [0, n)
    gives a zero row (``jax.nn.one_hot``'s rule)."""
    hot = (lab.long().unsqueeze(-1)
           == torch.arange(n, device=lab.device)).to(dtype)
    return hot if axis == -1 else hot.movedim(-1, axis)


@register("SoftmaxOutput")
def _softmax_output(data, label=None, grad_scale=1.0, ignore_label=-1,
                    multi_output=False, use_ignore=False, preserve_shape=False,
                    normalization="null", out_grad=False,
                    smooth_alpha=0.0, **kw):
    """Reference: src/operator/softmax_output.cc: softmax forward; the
    backward is ``(softmax - one_hot(label)) * grad_scale`` whatever the
    head gradient (a loss layer)."""
    _drop_name(kw)
    grad_scale = float(_lit(grad_scale))
    ignore_label = float(_lit(ignore_label))
    use_ignore = _b(use_ignore)
    multi_output = _b(multi_output)
    normalization = _lit(normalization)

    def axis_of(x):
        return 1 if (multi_output and x.ndim > 2) else -1

    def grad(out, x, lab):
        axis = axis_of(out)
        g = out - _one_hot(lab, out.shape[axis], axis, out.dtype)
        if use_ignore:
            keep = (lab != ignore_label).unsqueeze(
                axis if axis != -1 else out.ndim - 1)
            g = torch.where(keep, g, torch.zeros((), dtype=g.dtype,
                                                 device=g.device))
        scale = grad_scale
        if normalization == "batch":
            scale = scale / out.shape[0]
        elif normalization == "valid" and use_ignore:
            scale = scale / torch.clamp((lab != ignore_label).sum(), min=1)
        return g * scale

    return _loss_layer("softmax_output", data, label,
                       lambda x: torch.softmax(x, dim=axis_of(x)), grad)


@register("LinearRegressionOutput")
def _linear_regression_output(data, label=None, grad_scale=1.0, **kw):
    _drop_name(kw)
    gs = float(_lit(grad_scale))
    return _loss_layer(
        "linear_regression_output", data, label, lambda x: x.clone(),
        lambda out, x, lab: (x - lab.reshape(x.shape)) * gs / x.shape[0])


@register("LogisticRegressionOutput")
def _logistic_regression_output(data, label=None, grad_scale=1.0, **kw):
    _drop_name(kw)
    gs = float(_lit(grad_scale))
    return _loss_layer(
        "logistic_regression_output", data, label, torch.sigmoid,
        lambda out, x, lab: (out - lab.reshape(out.shape)) * gs
        / out.shape[0])


@register("MAERegressionOutput")
def _mae_regression_output(data, label=None, grad_scale=1.0, **kw):
    _drop_name(kw)
    gs = float(_lit(grad_scale))
    return _loss_layer(
        "mae_regression_output", data, label, lambda x: x.clone(),
        lambda out, x, lab: torch.sign(x - lab.reshape(x.shape)) * gs
        / x.shape[0])


@register("MakeLoss")
def _make_loss(data, grad_scale=1.0, valid_thresh=0.0,
               normalization="null", **kw):
    _drop_name(kw)
    scale = float(_lit(grad_scale))
    if _lit(normalization) == "batch":
        scale = scale / data.shape[0]
    return _loss_layer("make_loss", data, None, lambda x: x.clone(),
                       lambda out, x, lab: torch.full_like(x, scale))


@register("BlockGrad")
def _block_grad(data, **kw):
    _drop_name(kw)
    return _invoke(torch.Tensor.detach, (data,), "stop_gradient")


@register("IdentityAttachKLSparseReg")
def _identity_attach_kl(data, sparseness_target=0.1, penalty=0.001,
                        momentum=0.9, **kw):
    _drop_name(kw)
    return data


@register("CTCLoss")
def _ctc_loss(data, label=None, data_lengths=None, label_lengths=None,
              use_data_lengths=False, use_label_lengths=False,
              blank_label="first", **kw):
    """Reference: src/operator/nn/ctc_loss.cc; data (T, N, C), the loss a
    sequence. "first": blank 0, labels 1-based padded with 0; "last":
    blank C - 1, labels 0-based padded with -1."""
    _drop_name(kw)
    first = _lit(blank_label) == "first"
    use_dl = _b(use_data_lengths) and data_lengths is not None

    def fn(d, lab, *rest):
        t, n, c = d.shape
        logp = torch.log_softmax(d, dim=-1)
        lab = lab.long()
        if first:
            lengths, blank, targets = (lab > 0).sum(1), 0, lab.clamp(min=0)
        else:
            lengths, blank, targets = (lab >= 0).sum(1), c - 1, \
                lab.clamp(min=0)
        in_len = rest[0].long() if rest else torch.full(
            (n,), t, dtype=torch.long, device=d.device)
        return F.ctc_loss(logp, targets, in_len, lengths, blank=blank,
                          reduction="none")
    args = (data, label, data_lengths) if use_dl else (data, label)
    return _invoke(fn, args, "ctc_loss")


# -- misc ---------------------------------------------------------------------------

@register("ElementWiseSum")
def _element_wise_sum(*args, num_args=None, **kw):
    _drop_name(kw)
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("LRN")
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2, nsize=5, **kw):
    """Reference: src/operator/nn/lrn.cc: across-channel local response
    normalization (NCHW), ``x * (knorm + alpha / nsize * window sum of
    x^2)^-beta``."""
    _drop_name(kw)
    alpha, beta = float(_lit(alpha)), float(_lit(beta))
    knorm, nsize = float(_lit(knorm)), int(_lit(nsize))

    def fn(x):
        half = nsize // 2
        sq = F.pad(x * x, (0, 0, 0, 0, half, half))
        win = sq[:, :x.shape[1]]
        for j in range(1, nsize):
            win = win + sq[:, j:j + x.shape[1]]
        return x * torch.pow(knorm + alpha / nsize * win, -beta)
    return _invoke(fn, (data,), "lrn")


@register("ROIPooling")
def _roi_pooling(data, rois, pooled_size=None, spatial_scale=1.0, **kw):
    """Reference: src/operator/roi_pooling.cc; rois (n, 5) of [batch_idx,
    x1, y1, x2, y2] in image coordinates: the max of each bin."""
    _drop_name(kw)
    ph, pw = _tup(pooled_size, 2)
    scale = float(_lit(spatial_scale))

    def fn(x, r):
        h, w = x.shape[2], x.shape[3]
        b = r[:, 0].long()
        x1, y1, x2, y2 = (torch.round(r[:, i] * scale).long()
                          for i in (1, 2, 3, 4))
        bin_h = torch.clamp(y2 - y1 + 1, min=1).to(x.dtype) / ph
        bin_w = torch.clamp(x2 - x1 + 1, min=1).to(x.dtype) / pw

        def bounds(start, size, n):
            p = torch.arange(n, device=x.device, dtype=x.dtype)
            lo = start[:, None] + torch.floor(p * size[:, None]).long()
            hi = start[:, None] + torch.ceil((p + 1) * size[:, None]).long()
            return lo, hi
        ys, ye = bounds(y1, bin_h, ph)
        xs, xe = bounds(x1, bin_w, pw)
        iy = torch.arange(h, device=x.device)
        ix = torch.arange(w, device=x.device)
        my = (iy >= ys[..., None]) & (iy < ye[..., None])    # (R, ph, H)
        mx_ = (ix >= xs[..., None]) & (ix < xe[..., None])   # (R, pw, W)
        mask = my[:, :, None, :, None] & mx_[:, None, :, None, :]
        fmap = x.index_select(0, b)[:, :, None, None]       # (R, C, 1, 1, H, W)
        neg = torch.tensor(torch.finfo(x.dtype).min, dtype=x.dtype,
                           device=x.device)
        return torch.where(mask[:, None], fmap, neg).amax(dim=(-1, -2))
    return _invoke(fn, (data, rois), "roi_pooling")


@register("SequenceMask")
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0, **kw):
    _drop_name(kw)
    if not _b(use_sequence_length) or sequence_length is None:
        return data
    return _npx().sequence_mask(data, sequence_length,
                                use_sequence_length=True,
                                value=float(_lit(value)),
                                axis=int(_lit(axis)))


@register("SequenceLast")
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0, **kw):
    _drop_name(kw)
    return _npx().sequence_last(data, sequence_length,
                                use_sequence_length=_b(use_sequence_length),
                                axis=int(_lit(axis)))


@register("SequenceReverse")
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0, **kw):
    _drop_name(kw)
    return _npx().sequence_reverse(
        data, sequence_length, use_sequence_length=_b(use_sequence_length),
        axis=int(_lit(axis)))


@register("Softmax")
def _softmax_legacy(data, *args, **kw):
    """The 1.x alias of SoftmaxOutput; with a single input, softmax."""
    if args or "label" in kw:
        return _softmax_output(data, *args, **kw)
    _drop_name(kw)
    return _npx().softmax(data, axis=-1)


@register("Custom")
def _custom(*inputs, op_type=None, **kw):
    """A registered Python custom op (reference: mx.nd.Custom over
    src/operator/custom/custom.cc). ``mx.operator`` is not ported
    (ROADMAP.md Queue 1, item 9 (e)): this raises."""
    raise MXNetError(f"Custom(op_type={op_type!r}) needs mx.operator, which "
                     "is not ported yet (ROADMAP.md Queue 1, item 9 (e))")


# -- legacy snake_case names without a NumPy name --------------------------------------

def _register_aliases():
    pairs = {
        "broadcast_add": "add", "broadcast_plus": "add",
        "broadcast_sub": "subtract", "broadcast_minus": "subtract",
        "broadcast_mul": "multiply", "broadcast_div": "divide",
        "broadcast_mod": "mod", "broadcast_power": "power",
        "broadcast_maximum": "maximum", "broadcast_minimum": "minimum",
        "broadcast_equal": "equal", "broadcast_not_equal": "not_equal",
        "broadcast_greater": "greater",
        "broadcast_greater_equal": "greater_equal",
        "broadcast_lesser": "less", "broadcast_lesser_equal": "less_equal",
        "broadcast_logical_and": "logical_and",
        "broadcast_logical_or": "logical_or",
        "broadcast_logical_xor": "logical_xor",
        "broadcast_hypot": "hypot",
        "elemwise_add": "add", "elemwise_sub": "subtract",
        "elemwise_mul": "multiply", "elemwise_div": "divide",
    }
    for legacy, np_name in pairs.items():
        def mk(np_name=np_name, legacy=legacy):
            def fn(*args, **kwargs):
                _drop_name(kwargs)
                return getattr(_np(), np_name)(*args, **kwargs)
            fn.__name__ = legacy
            return fn
        LEGACY_OPS[legacy] = mk()

    def broadcast_to(data, shape=None, **kw):
        _drop_name(kw)
        # legacy: a 0 in the target keeps the source's axis
        shape = tuple(s if s != 0 else data.shape[i]
                      for i, s in enumerate(_tup(shape)))
        return _np().broadcast_to(data, shape)

    def broadcast_axis(data, axis=None, size=None, **kw):
        _drop_name(kw)
        target = list(data.shape)
        for a, s in zip(_tup(axis) or (), _tup(size) or ()):
            target[a] = s
        return _np().broadcast_to(data, tuple(target))

    def argmax_channel(data, **kw):
        _drop_name(kw)
        return _np().argmax(data, axis=1).astype(data.dtype)

    def identity(data, **kw):
        _drop_name(kw)
        return data + 0

    def zeros_like(data, **kw):
        _drop_name(kw)
        return _np().zeros_like(data)

    def ones_like(data, **kw):
        _drop_name(kw)
        return _np().ones_like(data)

    def norm(data, ord=2, axis=None, keepdims=False, **kw):  # noqa: A002
        from ..numpy.multiarray import _legacy_norm
        _drop_name(kw)
        ax = _tup(axis) if axis is not None else None
        if ax is not None and len(ax) == 1:
            ax = ax[0]
        return _legacy_norm(data, ord=_lit(ord), axis=ax,
                            keepdims=_b(keepdims))

    for fn in (broadcast_to, broadcast_axis, argmax_channel, identity,
               zeros_like, ones_like, norm):
        LEGACY_OPS[fn.__name__] = fn
    LEGACY_OPS["broadcast_axes"] = broadcast_axis
    LEGACY_OPS["stop_gradient"] = lambda data, **kw: _block_grad(data, **kw)
    LEGACY_OPS["flatten"] = lambda data, **kw: _flatten(data, **kw)


_register_aliases()


# -- the legacy linalg_* family --------------------------------------------------------
# Reference: src/operator/tensor/la_op.cc (exposed as nd.linalg_gemm ...): every
# op works on the last two axes and batches over the rest.

def _t(x, flag):
    return x.transpose(-1, -2) if flag else x


def _tri_solve(a, b, lower, left):
    return torch.linalg.solve_triangular(a, b, upper=not lower, left=left)


def _register_linalg():
    def gemm(A, B, C=None, transpose_a=False, transpose_b=False, alpha=1.0,
             beta=1.0, **kw):
        _drop_name(kw)
        a, b = _lit(alpha), _lit(beta)
        ta, tb = _b(transpose_a), _b(transpose_b)
        if C is None:
            return _invoke(lambda x, y: a * torch.matmul(_t(x, ta), _t(y, tb)),
                           (A, B), "linalg_gemm")
        return _invoke(
            lambda x, y, c: a * torch.matmul(_t(x, ta), _t(y, tb)) + b * c,
            (A, B, C), "linalg_gemm")

    def gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0, **kw):
        _drop_name(kw)
        a, ta, tb = _lit(alpha), _b(transpose_a), _b(transpose_b)
        return _invoke(lambda x, y: a * torch.matmul(_t(x, ta), _t(y, tb)),
                       (A, B), "linalg_gemm2")

    def potrf(A, **kw):
        _drop_name(kw)
        return _invoke(torch.linalg.cholesky, (A,), "linalg_potrf")

    def potri(A, **kw):
        """(L L^T)^-1 from the Cholesky factor L (reference: la_op.cc
        potri)."""
        _drop_name(kw)

        def fn(L):
            eye = torch.eye(L.shape[-1], dtype=L.dtype,
                            device=L.device).expand(L.shape)
            linv = _tri_solve(L, eye, True, True)
            return torch.matmul(linv.transpose(-1, -2), linv)
        return _invoke(fn, (A,), "linalg_potri")

    def trmm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0,
             **kw):
        _drop_name(kw)
        a, tr, rs, lo = _lit(alpha), _b(transpose), _b(rightside), _b(lower)

        def fn(x, y):
            # BLAS trmm: only the named triangle of A is read
            t = _t(torch.tril(x) if lo else torch.triu(x), tr)
            return a * (torch.matmul(y, t) if rs else torch.matmul(t, y))
        return _invoke(fn, (A, B), "linalg_trmm")

    def trsm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0,
             **kw):
        _drop_name(kw)
        a, tr, rs, lo = _lit(alpha), _b(transpose), _b(rightside), _b(lower)

        def fn(x, y):
            # op(A) X = alpha B, or X op(A) = alpha B (rightside); op(A)
            # = A^T swaps the triangle
            return _tri_solve(_t(x, tr), a * y, lo != tr, not rs)
        return _invoke(fn, (A, B), "linalg_trsm")

    def sumlogdiag(A, **kw):
        _drop_name(kw)
        return _invoke(lambda x: torch.log(torch.diagonal(
            x, dim1=-2, dim2=-1)).sum(-1), (A,), "linalg_sumlogdiag")

    def extractdiag(A, offset=0, **kw):
        _drop_name(kw)
        o = int(_lit(offset))
        return _invoke(lambda x: torch.diagonal(x, offset=o, dim1=-2,
                                                dim2=-1).clone(),
                       (A,), "linalg_extractdiag")

    def makediag(A, offset=0, **kw):
        _drop_name(kw)
        o = int(_lit(offset))
        return _invoke(lambda x: torch.diag_embed(x, offset=o),
                       (A,), "linalg_makediag")

    def _trian(n, o, lo, device):
        return torch.tril_indices(n, n, o, device=device) if lo \
            else torch.triu_indices(n, n, o, device=device)

    def extracttrian(A, offset=0, lower=True, **kw):
        _drop_name(kw)
        o, lo = int(_lit(offset)), _b(lower)

        def fn(x):
            r, c = _trian(x.shape[-1], o, lo, x.device)
            return x[..., r, c]
        return _invoke(fn, (A,), "linalg_extracttrian")

    def maketrian(A, offset=0, lower=True, **kw):
        _drop_name(kw)
        o, lo = int(_lit(offset)), _b(lower)

        def fn(x):
            m = x.shape[-1]
            # the extracttrian packing inverted: the smallest n whose
            # triangle (at this offset) holds exactly m elements
            n = 1
            while _trian(n, o, lo, "cpu").shape[1] < m:
                n += 1
            if _trian(n, o, lo, "cpu").shape[1] != m:
                raise MXNetError(
                    f"maketrian: {m} packed elements do not form a "
                    f"triangle with offset {o}")
            r, c = _trian(n, o, lo, x.device)
            out = x.new_zeros(x.shape[:-1] + (n, n))
            out[..., r, c] = x
            return out
        return _invoke(fn, (A,), "linalg_maketrian")

    def syrk(A, transpose=False, alpha=1.0, **kw):
        _drop_name(kw)
        a, tr = _lit(alpha), _b(transpose)

        def fn(x):
            xt = x.transpose(-1, -2)
            return a * (torch.matmul(xt, x) if tr else torch.matmul(x, xt))
        return _invoke(fn, (A,), "linalg_syrk")

    def syevd(A, **kw):
        _drop_name(kw)

        def fn(x):
            w, u = torch.linalg.eigh(x)
            return u.transpose(-1, -2), w   # the reference returns (U, L)
        return _invoke(fn, (A,), "linalg_syevd")

    def gelqf(A, **kw):
        _drop_name(kw)

        def fn(x):
            # LQ of (m, n), m <= n: A = L Q, Q's rows orthonormal
            q, r = torch.linalg.qr(x.transpose(-1, -2), mode="reduced")
            return r.transpose(-1, -2), q.transpose(-1, -2)
        return _invoke(fn, (A,), "linalg_gelqf")

    def inverse(A, **kw):
        _drop_name(kw)
        return _invoke(torch.linalg.inv, (A,), "linalg_inverse")

    def det(A, **kw):
        _drop_name(kw)
        return _invoke(torch.linalg.det, (A,), "linalg_det")

    def slogdet(A, **kw):
        _drop_name(kw)
        return _invoke(lambda x: tuple(torch.linalg.slogdet(x)), (A,),
                       "linalg_slogdet")

    for fn in (gemm, gemm2, potrf, potri, trmm, trsm, sumlogdiag,
               extractdiag, makediag, extracttrian, maketrian, syrk, syevd,
               gelqf, inverse, det, slogdet):
        name = f"linalg_{fn.__name__}"
        fn.__name__ = name
        LEGACY_OPS[name] = fn


_register_linalg()


# -- spatial sampling (1.x vision ops) ----------------------------------------------------

@register("BilinearSampler")
def _bilinear_sampler(data, grid, **kw):
    """Reference: src/operator/bilinear_sampler.cc: NCHW data sampled at
    normalized grid coordinates in [-1, 1], grid (N, 2, Ho, Wo) of (x, y);
    a sample outside reads 0."""
    _drop_name(kw)

    def fn(x, g):
        n, c, h, w = x.shape
        gx = (g[:, 0] + 1.0) * (w - 1) / 2.0       # (N, Ho, Wo)
        gy = (g[:, 1] + 1.0) * (h - 1) / 2.0
        x0, y0 = torch.floor(gx), torch.floor(gy)
        wx, wy = (gx - x0)[:, None].to(x.dtype), (gy - y0)[:, None].to(
            x.dtype)
        flat = x.reshape(n, c, h * w)

        def corner(cy, cx):
            inside = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
            idx = (cy.clamp(0, h - 1).long() * w
                   + cx.clamp(0, w - 1).long()).reshape(n, 1, -1)
            v = torch.gather(flat, 2, idx.expand(n, c, idx.shape[-1]))
            return v.reshape((n, c) + cy.shape[1:]) \
                * inside[:, None].to(x.dtype)

        return (corner(y0, x0) * (1 - wy) * (1 - wx)
                + corner(y0, x0 + 1) * (1 - wy) * wx
                + corner(y0 + 1, x0) * wy * (1 - wx)
                + corner(y0 + 1, x0 + 1) * wy * wx)
    return _invoke(fn, (data, grid), "BilinearSampler")


@register("GridGenerator")
def _grid_generator(data, transform_type="affine", target_shape=None, **kw):
    """Reference: src/operator/grid_generator.cc. affine: data (N, 6) ->
    grid (N, 2, H, W) of normalized (x, y); warp: data is the flow."""
    _drop_name(kw)
    tt = _lit(transform_type)
    shape = _tup(target_shape) if target_shape is not None else None

    def fn(d):
        if tt == "warp":
            _, _, h, w = d.shape
            xs = torch.linspace(-1, 1, w, dtype=d.dtype, device=d.device)
            ys = torch.linspace(-1, 1, h, dtype=d.dtype, device=d.device)
            gx = xs.expand(h, w) + d[:, 0] * 2.0 / max(w - 1, 1)
            gy = ys[:, None].expand(h, w) + d[:, 1] * 2.0 / max(h - 1, 1)
            return torch.stack([gx, gy], dim=1)
        h, w = shape
        theta = d.reshape(-1, 2, 3)
        xs = torch.linspace(-1, 1, w, dtype=d.dtype, device=d.device)
        ys = torch.linspace(-1, 1, h, dtype=d.dtype, device=d.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        coords = torch.stack([gx.reshape(-1), gy.reshape(-1),
                              torch.ones_like(gx).reshape(-1)])  # (3, HW)
        return torch.einsum("nij,jk->nik", theta, coords).reshape(-1, 2, h,
                                                                  w)
    return _invoke(fn, (data,), "GridGenerator")


@register("SpatialTransformer")
def _spatial_transformer(data, loc, target_shape=None,
                         transform_type="affine", sampler_type="bilinear",
                         **kw):
    """Reference: src/operator/spatial_transformer.cc: GridGenerator then
    BilinearSampler."""
    _drop_name(kw)
    grid = _grid_generator(loc, transform_type=transform_type,
                           target_shape=target_shape)
    return _bilinear_sampler(data, grid)
