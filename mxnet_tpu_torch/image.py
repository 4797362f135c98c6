"""mx.image — the image codecs and the batched image kernels.

Counterpart of ``mxnet_tpu/image.py``: ``imdecode``, ``imdecode_np``,
``imencode`` and ``imread`` as the reference has them, and ``imrotate`` /
``random_rotate`` (which the vision transforms call), PIL when it
imports and the raw ``.npy`` payload otherwise (a host without PIL reads
and writes ``.npy`` records only). The reference's native libjpeg codec,
its augmenters (``Augmenter`` and its subclasses, ``CreateAugmenter``) and
``ImageIter`` are not ported yet.

The private batched kernels below are the reference's, in torch: each
takes an (N, H, W, C) float32 batch on any device, so ``npx.image`` and
the vision transforms run on the host in a loader worker and on the card
alike. Crops and resizes are one affine resample with a fixed output shape
(per-sample separable tent-weight matrices applied as two ``einsum``
contractions), hue is a Rodrigues rotation about the gray axis, contrast
and saturation blend with the BT.601 luma.
"""
from __future__ import annotations

import io as _io

import numpy as onp
import torch

from .base import MXNetError

__all__ = ["imdecode", "imdecode_np", "imencode", "imread", "imrotate",
           "random_rotate"]


def _pil():
    try:
        from PIL import Image
        return Image
    except ImportError:
        return None


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode image bytes to an HWC ``ndarray`` on the current context
    (reference: image.py imdecode). A DataLoader worker runs inside
    ``with mx.cpu():``, so there the image stays on the host."""
    from .numpy.multiarray import array, ndarray
    if isinstance(buf, ndarray):
        buf = bytes(buf.asnumpy().astype(onp.uint8))
    return array(imdecode_np(buf, flag))


def imdecode_np(buf, flag=1):
    """Host-side decode to a numpy HWC array: raw ``.npy`` payloads load
    directly, everything else goes through PIL."""
    if buf[:6] == b"\x93NUMPY":
        arr = onp.load(_io.BytesIO(buf), allow_pickle=False)
    else:
        Image = _pil()
        if Image is None:
            raise MXNetError("no image codec available (PIL missing); "
                             "pack raw .npy payloads instead")
        img = Image.open(_io.BytesIO(buf)).convert("RGB" if flag else "L")
        arr = onp.asarray(img)
        if not flag:
            arr = arr[..., None]
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def imencode(img, fmt=".jpg", quality=95):
    """Encode an HWC image as ``fmt`` bytes (``.npy``: the raw codec)."""
    from .numpy.multiarray import ndarray
    if isinstance(img, ndarray):
        img = img.asnumpy()
    elif isinstance(img, torch.Tensor):
        img = img.cpu().numpy()
    Image = _pil()
    if Image is None or fmt == ".npy":
        bio = _io.BytesIO()
        onp.save(bio, onp.asarray(img))
        return bio.getvalue()
    bio = _io.BytesIO()
    Image.fromarray(onp.asarray(img).squeeze().astype(onp.uint8)).save(
        bio, format=fmt.strip(".").upper().replace("JPG", "JPEG"),
        quality=quality)
    return bio.getvalue()


def imread(filename, flag=1, to_rgb=True):
    """Reference: image.py imread (``.npy`` files load directly)."""
    if filename.endswith(".npy"):
        from .numpy.multiarray import array
        return array(onp.load(filename))
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb)


# ---------------------------------------------------------------------------
# batched kernels (N, H, W, C) float32
# ---------------------------------------------------------------------------

def _interp_weights(coords, size, bilinear):
    """(N, out) fractional source coords -> (N, out, size) weight matrix
    with <=2 nonzeros per row (tent kernel), edge-clamped."""
    c = torch.clamp(coords, 0.0, size - 1.0)
    if not bilinear:
        c = torch.round(c)
    grid = torch.arange(size, dtype=torch.float32, device=coords.device)
    return torch.clamp(1.0 - torch.abs(c[..., None] - grid), min=0.0)


def _affine_crop_resize(batch, y0, x0, hs, ws, out_hw, bilinear=True):
    """Per-sample window (y0, x0, hs, ws) resampled to ``out_hw``: one
    static output shape, the varying geometry in per-sample separable
    interpolation-weight matrices applied as two contractions."""
    _, H, W, _ = batch.shape
    oh, ow = out_hw
    dev = batch.device
    gy = (torch.arange(oh, device=dev, dtype=torch.float32) + 0.5) / oh
    gx = (torch.arange(ow, device=dev, dtype=torch.float32) + 0.5) / ow
    ys = y0[:, None] + gy[None, :] * hs[:, None] - 0.5   # (N, oh)
    xs = x0[:, None] + gx[None, :] * ws[:, None] - 0.5   # (N, ow)
    wy = _interp_weights(ys, H, bilinear)                # (N, oh, H)
    wx = _interp_weights(xs, W, bilinear)                # (N, ow, W)
    rows = torch.einsum("noh,nhwc->nowc", wy, batch)
    return torch.einsum("nxw,nowc->noxc", wx, rows)


def _batch_resize(batch, out_hw, bilinear=True):
    n, H, W, _ = batch.shape
    z = batch.new_zeros((n,))
    return _affine_crop_resize(batch, z, z, torch.full_like(z, float(H)),
                               torch.full_like(z, float(W)), out_hw,
                               bilinear)


def _rgb_luma(x):
    """Batch luminance (N, H, W, 1), ITU-R BT.601 weights."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=x.dtype, device=x.device)
    return (x * w).sum(-1, keepdim=True)


def _hue_rotate(x, theta):
    """Rotate (N, H, W, 3) batch colors by per-sample angles ``theta``
    about the gray axis (Rodrigues)."""
    dev = x.device
    c = torch.cos(theta)[:, None, None]
    s = torch.sin(theta)[:, None, None]
    eye = torch.eye(3, device=dev)
    axis = torch.ones((3, 3), device=dev) / 3.0   # uu^T, u the gray axis
    k = torch.tensor([[0.0, -1.0, 1.0],
                      [1.0, 0.0, -1.0],
                      [-1.0, 1.0, 0.0]], device=dev) \
        / torch.sqrt(torch.tensor(3.0, device=dev))  # cross matrix
    rot = c * eye + (1 - c) * axis + s * k      # (n, 3, 3)
    return torch.einsum("nhwc,ncd->nhwd", x, rot)


#: AlexNet PCA lighting (reference: npx.image adjust_lighting)
_EIGVAL = onp.array([55.46, 4.794, 1.148], "float32")
_EIGVEC = onp.array([[-0.5675, 0.7192, 0.4009],
                     [-0.5808, -0.0045, -0.8140],
                     [-0.5836, -0.6948, 0.4203]], "float32")


def _lighting(x, alpha):
    """Add the PCA lighting offset of per-sample ``alpha`` (N, 3)."""
    ev = torch.from_numpy(_EIGVAL).to(x.device)
    evec = torch.from_numpy(_EIGVEC).to(x.device)
    rgb = (alpha * ev) @ evec.T
    return x + rgb[:, None, None, :]


def _rotate_grid(batch, rad, zoom_in, zoom_out):
    """Rotate an NCHW fp32 batch by per-image ``rad`` (bilinear, zero
    outside): the reference's centered grid, rotated, normalized after the
    rotation, zoomed from the rotated corner extents."""
    n, c, h, w = batch.shape
    dev = batch.device
    hs, ws = (h - 1) / 2.0, (w - 1) / 2.0
    hm = (torch.arange(h, dtype=torch.float32, device=dev) - hs)[:, None]
    wm = (torch.arange(w, dtype=torch.float32, device=dev) - ws)[None, :]
    ca = torch.cos(rad)[:, None, None]
    sa = torch.sin(rad)[:, None, None]
    gx = (wm * ca - hm * sa) / ws
    gy = (wm * sa + hm * ca) / hs
    if zoom_in or zoom_out:
        rho = float(onp.sqrt(onp.float32(h * h + w * w)))
        ang = float(onp.arctan(h / w))
        ar = torch.abs(rad)
        c1x = torch.abs(rho * torch.cos(ang + ar))
        c1y = torch.abs(rho * torch.sin(ang + ar))
        c2x = torch.abs(rho * torch.cos(ang - ar))
        c2y = torch.abs(rho * torch.sin(ang - ar))
        mx_, my = torch.maximum(c1x, c2x), torch.maximum(c1y, c2y)
        scale = torch.maximum(mx_ / w, my / h) if zoom_out \
            else torch.minimum(w / mx_, h / my)
        gx, gy = gx * scale[:, None, None], gy * scale[:, None, None]
    x = (gx + 1.0) * ws
    y = (gy + 1.0) * hs
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[:, None], (y - y0)[:, None]
    flat = batch.reshape(n, c, h * w)

    def gather(yy, xx):
        valid = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
        xc = torch.clamp(xx, 0, w - 1).long()
        yc = torch.clamp(yy, 0, h - 1).long()
        idx = (yc * w + xc).reshape(n, 1, h * w).expand(n, c, h * w)
        vals = torch.gather(flat, 2, idx).reshape(n, c, h, w)
        return torch.where(valid[:, None], vals, vals.new_zeros(()))

    return (gather(y0, x0) * (1 - wx) * (1 - wy)
            + gather(y0, x0 + 1) * wx * (1 - wy)
            + gather(y0 + 1, x0) * (1 - wx) * wy
            + gather(y0 + 1, x0 + 1) * wx * wy)


def imrotate(src, rotation_degrees, zoom_in=False, zoom_out=False):
    """Rotate CHW / NCHW float32 image(s) (reference image.py:618): a
    batch takes a per-image angle vector or a scalar; ``zoom_in`` crops so
    no padding shows, ``zoom_out`` shrinks so the whole source stays."""
    from .numpy.multiarray import _wrap, ndarray
    if zoom_in and zoom_out:
        raise MXNetError("`zoom_in` and `zoom_out` cannot be both True")
    raw = src._data if isinstance(src, ndarray) else torch.as_tensor(src)
    if raw.dtype != torch.float32:
        raise MXNetError("imrotate supports float32 only (call after "
                         "ToTensor); got " + str(raw.dtype))
    if raw.ndim not in (3, 4):
        raise MXNetError("imrotate takes CHW or NCHW input")
    single = raw.ndim == 3
    n = 1 if single else raw.shape[0]
    if onp.isscalar(rotation_degrees):
        deg = onp.full((n,), rotation_degrees, "float32")
    else:
        if single:
            raise MXNetError("single image takes a scalar angle")
        deg = onp.asarray(
            rotation_degrees.asnumpy()
            if isinstance(rotation_degrees, ndarray) else rotation_degrees,
            "float32").reshape(-1)
    if len(deg) != n:
        raise MXNetError(f"{n} images but {len(deg)} angles")
    rad = torch.from_numpy(deg).to(raw.device) * (onp.pi / 180.0)
    out = _rotate_grid(raw[None] if single else raw, rad, zoom_in, zoom_out)
    return _wrap(out[0] if single else out)


def random_rotate(src, angle_limits, zoom_in=False, zoom_out=False):
    """Rotate by angle(s) drawn uniformly from ``angle_limits`` with
    numpy's global generator (reference image.py:727)."""
    lo, hi = angle_limits
    if lo >= hi:
        raise MXNetError("`angle_limits` must be an ordered tuple")
    if getattr(src, "ndim", 3) == 3:
        angle = float(onp.random.uniform(lo, hi))
    else:
        angle = onp.random.uniform(lo, hi, size=(src.shape[0],)) \
            .astype("float32")
    return imrotate(src, angle, zoom_in, zoom_out)
