"""gluon.utils.

Counterpart of ``mxnet_tpu/gluon/utils.py``: ``split_data`` and
``split_and_load`` (a batch scattered over devices), ``clip_global_norm``,
``check_sha1``, ``download`` (no network: ``file://`` URLs and files
already in place, as the reference has it) and ``shape_is_known``.

``clip_global_norm`` computes the global L2 norm in one reduction
(``torch._foreach_norm`` in fp32, then the norm of the norms). With
``check_isfinite`` (the default) it reads the norm on the host once, as
the reference does (reported to ``pipeline.sync_guard``, as the Trainer's
finite check is): a non-finite norm warns and scales nothing, else each
array is scaled by ``max_norm / (norm + 1e-8)`` where that is below 1,
and the norm returns as a float. With ``check_isfinite=False`` nothing is
read: the scale ``min(1, max_norm / (norm + 1e-8))`` applies on the
device and the norm returns as a 0-d tensor (as upstream MXNet returns an
NDArray there; the JAX package returns a float either way).
"""
from __future__ import annotations

import hashlib
import os
import shutil
import warnings

import torch

from .. import pipeline as _pipeline
from ..base import MXNetError

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download", "shape_is_known"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``, the last
    taking the remainder (reference: utils.py ``split_data``)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"batch size {size} not divisible by {num_slice} slices")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        lo = i * step
        hi = (i + 1) * step if i < num_slice - 1 else size
        idx = [slice(None)] * data.ndim
        idx[batch_axis] = slice(lo, hi)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Scatter a batch over ``ctx_list`` (contexts or devices): one slice
    on each (reference: utils.py ``split_and_load``). A host array becomes
    an ``mx.np`` array."""
    from ..numpy import array
    from ..numpy.multiarray import ndarray
    if not isinstance(data, (ndarray, torch.Tensor)):
        data = array(data)
    if len(ctx_list) == 1:
        return [_to(data, ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [_to(s, ctx) for s, ctx in zip(slices, ctx_list)]


def _to(x, ctx):
    if isinstance(x, torch.Tensor):
        from ..context import resolve_device
        return x.to(resolve_device(ctx))
    return x.as_in_ctx(ctx)


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` (tensors or ``mx.np`` arrays, in place) so their
    global L2 norm is at most ``max_norm``; returns the norm before
    scaling (reference: utils.py ``clip_global_norm``)."""
    if not arrays:
        raise MXNetError("clip_global_norm needs at least one array")
    for a in arrays:
        if hasattr(a, "stype") and a.stype != "default":
            # the reference raises AttributeError here too (it reads ._data)
            raise AttributeError(
                f"clip_global_norm takes dense arrays, not a {a.stype} "
                "one: clip the dense gradients only")
    raws = [getattr(a, "_data", a) for a in arrays]
    norms = torch._foreach_norm(raws, 2, dtype=torch.float32)
    total = torch.linalg.vector_norm(torch.stack(norms))
    if not check_isfinite:
        scale = torch.clamp(max_norm / (total + 1e-8), max=1.0)
        _scale(arrays, raws, scale)
        return total
    if _pipeline._guard_depth:
        _pipeline.note_host_sync("gluon.clip_global_norm")
    total_norm = total.item()
    if total_norm != total_norm or total_norm in (float("inf"),
                                                  float("-inf")):
        warnings.warn("nan or inf in clip_global_norm")
        return total_norm
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        _scale(arrays, raws, scale)
    return total_norm


@torch.no_grad()
def _scale(arrays, raws, scale):
    """Each array times ``scale`` (a float or a 0-d tensor) in its dtype:
    tensors in place, ``mx.np`` arrays rebound."""
    if isinstance(scale, torch.Tensor):
        scaled = [r * scale.to(r.dtype) for r in raws]
    else:
        scaled = torch._foreach_mul(raws, scale)
    for a, r, new in zip(arrays, raws, scaled):
        if a is r:
            r.copy_(new)
        else:
            a._rebind(new)


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 hex digest is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """Reference: utils.py ``download``, without the network: a
    ``file://`` URL is copied to ``path``, and a file already at ``path``
    is kept; any other URL raises."""
    fname = path or url.split("/")[-1]
    if url.startswith("file://"):
        src = url[len("file://"):]
        if src != fname:
            shutil.copyfile(src, fname)
        return fname
    if os.path.exists(fname) and not overwrite:
        return fname
    raise MXNetError(f"download of {url} unavailable (no network egress); "
                     "place the file at the target path manually")


def shape_is_known(shape):
    """Whether every dimension of ``shape`` is known (above 0)."""
    if shape is None:
        return False
    return all(s > 0 for s in shape)
