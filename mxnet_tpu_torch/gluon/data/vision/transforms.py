"""Vision transforms.

Counterpart of ``mxnet_tpu/gluon/data/vision/transforms.py`` (reference
parity: python/mxnet/gluon/data/vision/transforms/): each transform is a
block over the ``npx.image`` operators and takes HWC (one image) or NHWC
(a batch) input, on the host in a loader worker or on the card. The port
has no separate ``Block`` class: every transform is a ``HybridBlock``, and
``Compose`` a ``Sequential``. Random transforms draw from the default
generator of their input's device (``random.default_generator``), the
host-coin ones (``RandomApply``, ``RandomRotation``) from numpy's global
generator, as in the reference.
"""
from __future__ import annotations

import numpy as onp
import torch

from .... import numpy_extension as npx
from .... import random as _random
from ....image import imrotate, random_rotate
from ....numpy.multiarray import _wrap
from ...block import HybridBlock
from ...nn import HybridSequential, Sequential

__all__ = ["Compose", "HybridCompose", "Cast", "ToTensor", "Normalize",
           "Resize", "CenterCrop", "RandomCrop", "RandomResizedCrop",
           "RandomFlipLeftRight", "RandomFlipTopBottom", "RandomBrightness",
           "RandomContrast", "RandomSaturation", "RandomHue",
           "RandomColorJitter", "RandomLighting", "RandomApply",
           "HybridRandomApply", "CropResize", "RandomGray", "Rotate",
           "RandomRotation"]


class Compose(Sequential):
    """Reference: transforms Compose."""

    def __init__(self, transforms):
        super().__init__()
        self.add(*transforms)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return _wrap(x).astype(self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (reference: ToTensor over
    _image_to_tensor)."""

    def forward(self, x):
        return npx.image.to_tensor(x)


class Normalize(HybridBlock):
    """Channel-wise normalization on CHW/NCHW input (reference: Normalize
    over _image_normalize)."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = onp.asarray(mean, dtype=onp.float32)
        self._std = onp.asarray(std, dtype=onp.float32)

    def forward(self, x):
        return npx.image.normalize(x, self._mean, self._std)


class Resize(HybridBlock):
    """Reference: transforms Resize over _image_resize."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interp = interpolation

    def forward(self, x):
        return npx.image.resize(x, self._size, self._keep, self._interp)


class CenterCrop(HybridBlock):
    """Reference: transforms CenterCrop — random_crop at the fixed
    fractional position (0.5, 0.5), upsampling a smaller source."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._interp = interpolation

    def forward(self, x):
        return npx.image.random_crop(x, (0.5, 0.5), (0.5, 0.5),
                                     width=self._size[0],
                                     height=self._size[1],
                                     interp=self._interp)


class RandomCrop(HybridBlock):
    """Reference: transforms RandomCrop (optional zero padding first)."""

    def __init__(self, size, pad=None, pad_value=0, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._interp = interpolation
        self._pad = pad
        self._pad_value = pad_value

    def forward(self, x):
        if self._pad:
            p = self._pad
            pw = ((p, p), (p, p), (0, 0)) if isinstance(p, int) else p
            if x.ndim == 4:
                pw = ((0, 0),) + tuple(pw)
            flat = [v for pair in reversed(pw) for v in pair]
            x = torch.nn.functional.pad(x, flat, mode="constant",
                                        value=self._pad_value)
        return npx.image.random_crop(x, (0, 1), (0, 1),
                                     width=self._size[0],
                                     height=self._size[1],
                                     interp=self._interp)


class RandomResizedCrop(HybridBlock):
    """Reference: transforms RandomResizedCrop over
    _image_random_resized_crop."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio
        self._interp = interpolation

    def forward(self, x):
        return npx.image.random_resized_crop(
            x, width=self._size[0], height=self._size[1], area=self._scale,
            ratio=self._ratio, interp=self._interp)


class RandomFlipLeftRight(HybridBlock):
    def forward(self, x):
        return npx.image.random_flip_left_right(x)


class RandomFlipTopBottom(HybridBlock):
    def forward(self, x):
        return npx.image.random_flip_top_bottom(x)


class RandomBrightness(HybridBlock):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        return npx.image.random_brightness(x, max(0.0, 1 - self._b),
                                           1 + self._b)


class RandomContrast(HybridBlock):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        return npx.image.random_contrast(x, max(0.0, 1 - self._c),
                                         1 + self._c)


class RandomSaturation(HybridBlock):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        return npx.image.random_saturation(x, max(0.0, 1 - self._s),
                                           1 + self._s)


class RandomHue(HybridBlock):
    def __init__(self, hue):
        super().__init__()
        self._h = hue

    def forward(self, x):
        return npx.image.random_hue(x, max(0.0, 1 - self._h), 1 + self._h)


class RandomColorJitter(HybridBlock):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._args = (brightness, contrast, saturation, hue)

    def forward(self, x):
        return npx.image.random_color_jitter(x, *self._args)


class RandomLighting(HybridBlock):
    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return npx.image.random_lighting(x, self._alpha)


class HybridCompose(HybridSequential):
    """Compose over hybridizable transforms, hybridized at once
    (reference: transforms/__init__.py:81)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            if not isinstance(t, HybridBlock) or isinstance(
                    t, (RandomApply, RandomRotation)):
                # a host-coin transform would freeze its coin into a
                # captured graph (the reference raises the same way)
                raise ValueError(
                    f"HybridCompose requires HybridBlocks, got {type(t)}; "
                    "use Compose for host-random transforms")
        self.add(*transforms)
        self.hybridize()


class RandomApply(HybridBlock):
    """Apply ``transforms`` with probability ``p`` (a host coin from
    numpy's global generator; reference: transforms/__init__.py:138)."""

    def __init__(self, transforms, p=0.5):
        super().__init__()
        self.transforms = transforms
        self.p = p

    def forward(self, x):
        if self.p < onp.random.random():
            return x
        return self.transforms(x)


class HybridRandomApply(HybridBlock):
    """Traceable RandomApply: the coin is a device draw and both branches
    are data flow (reference: transforms/__init__.py:168)."""

    def __init__(self, transforms, p=0.5):
        super().__init__()
        if not isinstance(transforms, HybridBlock):
            raise TypeError("HybridRandomApply requires a HybridBlock")
        self.transforms = transforms
        self.p = p

    def forward(self, x):
        gen = _random.default_generator(x.device)
        _random.note_draw(gen)
        coin = torch.rand((), generator=gen, device=x.device)
        return torch.where(coin < self.p, self.transforms(x), x)


class CropResize(HybridBlock):
    """Fixed crop then optional resize (reference: transforms/image.py:260).
    HWC or NHWC."""

    def __init__(self, x, y, width, height, size=None, interpolation=None):
        super().__init__()
        self._x, self._y = x, y
        self._w, self._h = width, height
        self._size = (size, size) if isinstance(size, int) else size
        self._interp = 1 if interpolation is None else interpolation

    def forward(self, data):
        out = npx.image.crop(data, self._x, self._y, self._w, self._h)
        if self._size:
            out = npx.image.resize(out, self._size, False, self._interp)
        return out


class RandomGray(HybridBlock):
    """Convert to 3-channel luma with probability ``p`` (reference:
    transforms/image.py:664, with the intended BT.601 luma replicated per
    channel as the JAX package has it)."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        w = torch.tensor([0.2989, 0.5870, 0.1140], device=x.device)
        xf = x.to(torch.float32)
        gray = (xf * w).sum(-1, keepdim=True).expand(xf.shape)
        gen = _random.default_generator(x.device)
        _random.note_draw(gen)
        coin = torch.rand((), generator=gen, device=x.device)
        return torch.where(coin < self.p, gray, xf)


class Rotate(HybridBlock):
    """Rotate by a fixed angle, CHW/NCHW float32 (reference:
    transforms/image.py:144 over image.imrotate)."""

    def __init__(self, rotation_degrees, zoom_in=False, zoom_out=False):
        super().__init__()
        self._args = (rotation_degrees, zoom_in, zoom_out)

    def forward(self, x):
        return imrotate(x, *self._args)


class RandomRotation(HybridBlock):
    """Rotate by a uniform random angle in ``angle_limits`` with
    probability ``rotate_with_proba`` (reference: transforms/image.py:175
    over image.random_rotate)."""

    def __init__(self, angle_limits, zoom_in=False, zoom_out=False,
                 rotate_with_proba=1.0):
        super().__init__()
        lower, upper = angle_limits
        if lower >= upper:
            raise ValueError("`angle_limits` must be an ordered tuple")
        if not 0 <= rotate_with_proba <= 1:
            raise ValueError("rotate_with_proba must be in [0, 1]")
        self._args = (angle_limits, zoom_in, zoom_out)
        self._proba = rotate_with_proba

    def forward(self, x):
        if onp.random.random() > self._proba:
            return x
        return random_rotate(x, *self._args)
