"""Device meshes, one card.

Counterpart of ``mxnet_tpu/parallel/mesh.py`` (``MeshConfig``,
``make_mesh``) for a single device: the axis names and sizes, the batch
partition specs and the mesh object that ``ShardedTrainStep`` reads. A mesh
of more than one device raises: multi-card (``torch.distributed``) is a
later slice of the port. ``P`` is the port's own stand-in for JAX's
``PartitionSpec``: a tuple of axis names (or None) per array dimension.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["P", "Mesh", "make_mesh", "MeshConfig"]


class P(tuple):
    """Partition spec: one axis name (or None, or a tuple of names) per
    dimension, e.g. ``P("dp", None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """Named axes over devices: ``shape`` is {axis: size}, ``devices`` the
    flat device list (one device in this slice)."""

    def __init__(self, shape, devices):
        self.shape = dict(shape)
        self.devices = list(devices)
        self.axis_names = tuple(self.shape)


def _one_card(what, total):
    if total != 1:
        raise MXNetError(f"{what} spans {total} devices: multi-card meshes "
                         "(torch.distributed) are a later slice of the port; "
                         "this slice runs on one card")


def make_mesh(axes, devices=None):
    """A :class:`Mesh` from {'dp': 1, ...} over ``devices`` (default
    ``[cuda:0]``). Raises unless the axis product is 1."""
    sizes = {name: int(v) for name, v in axes.items()}
    _one_card(f"mesh {sizes}", math.prod(sizes.values()))
    devices = [resolve_device(None)] if devices is None else [
        torch.device(d) for d in devices]
    return Mesh(sizes, devices[:1])


class MeshConfig:
    """The composed-parallelism entry point: ``dp`` (data), ``tp``
    (tensor), ``pp`` (pipeline), ``sp`` (sequence). All four axes always
    exist in the built mesh (size-1 axes are free), so specs naming any of
    them stay valid. Only the one-card layout builds in this slice."""

    AXES = ("dp", "pp", "sp", "tp")

    def __init__(self, dp=1, tp=1, pp=1, sp=1):
        for name, v in (("dp", dp), ("tp", tp), ("pp", pp), ("sp", sp)):
            if int(v) != v or int(v) < 1:
                raise MXNetError(
                    f"MeshConfig {name}={v!r}: axis sizes are integers >= 1")
        self.dp, self.tp, self.pp, self.sp = int(dp), int(tp), int(pp), \
            int(sp)

    @property
    def shape(self):
        """Ordered {axis: size} over all four axes (size-1 included)."""
        return {a: getattr(self, a) for a in self.AXES}

    def size(self):
        return self.dp * self.tp * self.pp * self.sp

    def build(self, devices=None):
        """The :class:`Mesh` (raises for more than one device)."""
        _one_card(repr(self), self.size())
        return make_mesh(self.shape, devices)

    def batch_spec(self, ndim):
        """Spec of one batch array: the leading (batch) dim over 'dp', the
        second (sequence) dim over 'sp' when sp > 1."""
        if ndim < 1:
            return P()
        parts = ["dp"]
        if ndim >= 2:
            parts.append("sp" if self.sp > 1 else None)
        return P(*parts)

    def batch_specs(self, *ndims):
        """Specs for an (inputs..., labels...) batch given each array's
        rank, e.g. ``cfg.batch_specs(2, 2)`` for GPT (tokens, labels)."""
        return tuple(self.batch_spec(n) for n in ndims)

    def __repr__(self):
        return (f"MeshConfig(dp={self.dp}, tp={self.tp}, pp={self.pp}, "
                f"sp={self.sp})")
