"""npx.image — the image operator namespace.

Counterpart of ``mxnet_tpu/numpy_extension/image.py`` (reference:
src/operator/image/ ``_image_to_tensor``, ``_image_normalize``,
``_image_resize``, ``_image_crop``, ``_image_random_crop``,
``_image_random_resized_crop``, the flips, the random color ops and
lighting), backing ``gluon.data.vision.transforms``.

Every op takes HWC (3-D) or NHWC (4-D batch) input as an ``mx.np``
array, a tensor or a numpy array, runs on the input's device (the host in
a loader worker, the card in a step) through the batched kernels of
``mxnet_tpu_torch/image.py``, and returns an ``mx.np`` array. Integer
images are computed in float32, rounded half to even and clipped to
[0, 255].

The random ops draw per sample from ``generator``, a ``torch.Generator``
on the input's device, else from ``random.default_generator`` of that
device. The reference draws from its JAX key, so the two packages'
streams cannot match: the ops compute the same function of the draw.
"""
from __future__ import annotations

import itertools
import math

import numpy as onp
import torch

from .. import random as _random
from ..base import MXNetError
from ..image import (_affine_crop_resize, _batch_resize, _hue_rotate,
                     _lighting, _rgb_luma)
from ..numpy.multiarray import _wrap, ndarray

__all__ = ["to_tensor", "normalize", "resize", "crop", "random_crop",
           "random_resized_crop", "flip_left_right", "flip_top_bottom",
           "random_flip_left_right", "random_flip_top_bottom",
           "random_brightness", "random_contrast", "random_saturation",
           "random_hue", "random_color_jitter", "adjust_lighting",
           "random_lighting"]


def _raw(x):
    if isinstance(x, ndarray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(onp.ascontiguousarray(onp.asarray(x)))


def _batched(x):
    """(raw NHWC batch, had_batch_dim)."""
    r = _raw(x)
    if r.ndim == 3:
        return r[None], False
    if r.ndim == 4:
        return r, True
    raise MXNetError(f"image ops expect HWC or NHWC input, got "
                     f"{tuple(r.shape)}")


def _debatch(out, batched):
    return _wrap(out if batched else out[0])


def _finish(out, dt):
    """Back to the input dtype: integer images rounded and clipped."""
    if not dt.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(dt)


def _gen(r, generator):
    return generator if generator is not None \
        else _random.default_generator(r.device)


def _uniform(gen, shape, lo, hi, device):
    _random.note_draw(gen)
    u = torch.rand(shape, generator=gen, device=device)
    return u * (hi - lo) + lo


def to_tensor(data):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (reference:
    image_random.cc _image_to_tensor; NHWC -> NCHW for batches)."""
    r = _raw(data)
    scaled = r.to(torch.float32) / 255.0
    if r.ndim == 3:
        return _wrap(scaled.permute(2, 0, 1).contiguous())
    return _wrap(scaled.permute(0, 3, 1, 2).contiguous())


def _param(v, device):
    if isinstance(v, ndarray):
        v = v._data
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.as_tensor(onp.asarray(v, onp.float32), device=device)


def normalize(data, mean=0.0, std=1.0):
    """Channel-wise normalize on CHW/NCHW float input (reference:
    _image_normalize)."""
    r = _raw(data)
    c_axis = r.ndim - 3  # CHW -> 0, NCHW -> 1
    shape = [1] * r.ndim
    shape[c_axis] = -1
    m = _param(mean, r.device).reshape(shape)
    s = _param(std, r.device).reshape(shape)
    return _wrap((r - m) / s)


def resize(data, size, keep_ratio=False, interp=1):
    """Reference: resize.cc _image_resize. ``size``: int or (w, h)."""
    r, batched = _batched(data)
    h, w = r.shape[1], r.shape[2]
    if isinstance(size, int):
        if keep_ratio:
            out_hw = (int(h * size / w), size) if h > w \
                else (size, int(w * size / h))
        else:
            out_hw = (size, size)
    else:
        out_hw = (size[1], size[0])
    out = _batch_resize(r.to(torch.float32), out_hw, bilinear=bool(interp))
    return _debatch(_finish(out, r.dtype), batched)


def crop(data, x, y, width, height):
    """Reference: crop.cc _image_crop (x, y = top-left corner)."""
    r, batched = _batched(data)
    return _debatch(r[:, y:y + height, x:x + width], batched)


def random_crop(data, xrange=(0.0, 1.0), yrange=(0.0, 1.0), width=None,
                height=None, interp=1, generator=None):
    """Crop ``width`` x ``height`` at a fractional position drawn per
    sample from ``xrange`` / ``yrange`` (reference: crop-inl.h RandomCrop;
    CenterCrop passes (0.5, 0.5)); upsamples a source smaller than the
    target."""
    if width is None or height is None:
        raise MXNetError("random_crop requires width and height")
    r, batched = _batched(data)
    n, h, w = r.shape[0], r.shape[1], r.shape[2]
    gen = _gen(r, generator)
    fx = _uniform(gen, (n,), xrange[0], xrange[1], r.device)
    fy = _uniform(gen, (n,), yrange[0], yrange[1], r.device)
    cw, ch = min(width, w), min(height, h)
    x0 = torch.floor(fx * (w - cw + 1))
    y0 = torch.floor(fy * (h - ch + 1))
    out = _affine_crop_resize(r.to(torch.float32), y0, x0,
                              torch.full_like(x0, float(ch)),
                              torch.full_like(x0, float(cw)),
                              (height, width), bilinear=bool(interp))
    return _debatch(_finish(out, r.dtype), batched)


def random_resized_crop(data, width=None, height=None, area=(0.08, 1.0),
                        ratio=(3 / 4.0, 4 / 3.0), interp=1, max_trial=10,
                        generator=None):
    """Inception-style random area / aspect crop resized to (width,
    height) (reference: crop-inl.h RandomResizedCrop), as one affine
    resample: per sample an area share and a log-uniform aspect, the
    window clamped to the image (the batched form of the reference's
    retries), then its corner."""
    r, batched = _batched(data)
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    n, H, W = r.shape[0], r.shape[1], r.shape[2]
    gen = _gen(r, generator)
    dev = r.device
    a = _uniform(gen, (n,), area[0], area[1], dev) * (H * W)
    logr = _uniform(gen, (n,), math.log(ratio[0]), math.log(ratio[1]), dev)
    aspect = torch.exp(logr)
    ws = torch.clamp(torch.sqrt(a * aspect), max=float(W))
    hs = torch.clamp(torch.sqrt(a / aspect), max=float(H))
    y0 = _uniform(gen, (n,), 0.0, 1.0, dev) * (H - hs)
    x0 = _uniform(gen, (n,), 0.0, 1.0, dev) * (W - ws)
    out = _affine_crop_resize(r.to(torch.float32), y0, x0, hs, ws,
                              (height, width), bilinear=bool(interp))
    return _debatch(_finish(out, r.dtype), batched)


def flip_left_right(data):
    r, batched = _batched(data)
    return _debatch(torch.flip(r, (2,)), batched)


def flip_top_bottom(data):
    r, batched = _batched(data)
    return _debatch(torch.flip(r, (1,)), batched)


def _random_flip(data, axis, p, generator):
    r, batched = _batched(data)
    gen = _gen(r, generator)
    flip = _uniform(gen, (r.shape[0],), 0.0, 1.0, r.device) < p
    out = torch.where(flip[:, None, None, None], torch.flip(r, (axis,)), r)
    return _debatch(out, batched)


def random_flip_left_right(data, p=0.5, generator=None):
    return _random_flip(data, 2, p, generator)


def random_flip_top_bottom(data, p=0.5, generator=None):
    return _random_flip(data, 1, p, generator)


def _blend(x, mode, alpha):
    """The reference's enhance blends: brightness scales, contrast blends
    with the image's mean luma, saturation with each pixel's luma."""
    if mode == "brightness":
        return x * alpha
    if mode == "contrast":
        mean_luma = _rgb_luma(x).mean(dim=(1, 2), keepdim=True)
        return x * alpha + mean_luma * (1.0 - alpha)
    if mode == "saturation":
        return x * alpha + _rgb_luma(x) * (1.0 - alpha)
    raise MXNetError(f"unknown enhance mode {mode!r}")


def _enhance(data, mode, min_factor, max_factor, generator):
    r, batched = _batched(data)
    gen = _gen(r, generator)
    alpha = _uniform(gen, (r.shape[0], 1, 1, 1), min_factor, max_factor,
                     r.device)
    out = _blend(r.to(torch.float32), mode, alpha)
    return _debatch(_finish(out, r.dtype), batched)


def random_brightness(data, min_factor, max_factor, generator=None):
    return _enhance(data, "brightness", min_factor, max_factor, generator)


def random_contrast(data, min_factor, max_factor, generator=None):
    return _enhance(data, "contrast", min_factor, max_factor, generator)


def random_saturation(data, min_factor, max_factor, generator=None):
    return _enhance(data, "saturation", min_factor, max_factor, generator)


def random_hue(data, min_factor, max_factor, generator=None):
    """Hue rotation with factor drawn in [min, max] (reference:
    image_random.cc RandomHue); 1.0 is the identity, theta = (f - 1) pi."""
    r, batched = _batched(data)
    gen = _gen(r, generator)
    f = _uniform(gen, (r.shape[0],), min_factor, max_factor, r.device)
    out = _hue_rotate(r.to(torch.float32), (f - 1.0) * math.pi)
    return _debatch(_finish(out, r.dtype), batched)


def random_color_jitter(data, brightness=0, contrast=0, saturation=0, hue=0,
                        generator=None):
    """Brightness, contrast and saturation jitter (each factor 1 + U(-j,
    j) per sample) in one random order for the batch, then hue jitter
    (theta = U(-hue, hue) pi), as the reference's ColorJitterAug and
    HueJitterAug."""
    r, batched = _batched(data)
    gen = _gen(r, generator)
    dev = r.device
    x = r.to(torch.float32)
    n = r.shape[0]
    modes = [(m, j) for m, j in (("brightness", brightness),
                                 ("contrast", contrast),
                                 ("saturation", saturation)) if j > 0]
    if modes:
        perms = list(itertools.permutations(range(len(modes))))
        _random.note_draw(gen)
        pick = int(torch.randint(len(perms), (1,), generator=gen,
                                 device=dev).item())
        for j in perms[pick]:
            mode, jit = modes[j]
            alpha = 1.0 + _uniform(gen, (n, 1, 1, 1), -jit, jit, dev)
            x = _blend(x, mode, alpha)
    if hue:
        theta = _uniform(gen, (n,), -hue, hue, dev) * math.pi
        x = _hue_rotate(x, theta)
    return _debatch(_finish(x, r.dtype), batched)


def adjust_lighting(data, alpha):
    """AlexNet-PCA lighting with a fixed ``alpha`` (reference:
    image_random.cc _image_adjust_lighting)."""
    r, batched = _batched(data)
    a = torch.broadcast_to(_param(alpha, r.device), (r.shape[0], 3))
    out = _lighting(r.to(torch.float32), a)
    return _debatch(_finish(out, r.dtype), batched)


def random_lighting(data, alpha_std=0.05, generator=None):
    """AlexNet-PCA lighting, alpha ~ N(0, alpha_std) per sample and
    channel."""
    r, batched = _batched(data)
    gen = _gen(r, generator)
    _random.note_draw(gen)
    alpha = torch.randn((r.shape[0], 3), generator=gen,
                        device=r.device) * alpha_std
    out = _lighting(r.to(torch.float32), alpha)
    return _debatch(_finish(out, r.dtype), batched)
