"""Device meshes over the process group.

Counterpart of ``mxnet_tpu/parallel/mesh.py``: ``make_mesh``,
``MeshConfig``, ``mesh_factorizations``, ``data_parallel_mesh``,
``set_mesh`` / ``current_mesh``, ``shard`` / ``replicate``. The reference
lays a mesh over devices of one program; here a mesh is the world's ranks
(one process each, ``torch.distributed``) under named axes, with the
device this process runs on. Its ``group`` is the process group of the
mesh's ranks (None: the whole world) and ``rank`` this process's place
in it.

This slice runs data parallelism: ``dp`` may span every rank; a ``tp``,
``pp`` or ``sp`` axis above 1 raises (tensor, pipeline and sequence
parallelism are slice 22 of the port). A mesh whose axis product
undershoots the world strands the rest of the ranks: it warns and sets
the ``mesh.unused_devices`` gauge, as the reference does. ``P`` is the
port's stand-in for JAX's ``PartitionSpec``: a tuple of axis names (or
None) per array dimension.
"""
from __future__ import annotations

import math
import warnings

import torch

from .. import telemetry as _telemetry
from ..base import MXNetError
from ..context import resolve_device

__all__ = ["P", "Mesh", "make_mesh", "MeshConfig", "mesh_factorizations",
           "data_parallel_mesh", "set_mesh", "current_mesh", "shard",
           "replicate"]

_telemetry.declare_metric(
    "mesh.unused_devices", "gauge",
    "ranks stranded by the last make_mesh call whose axis product "
    "undershot the world size (training silently runs on a subset)")

_current = None


class P(tuple):
    """Partition spec: one axis name (or None, or a tuple of names) per
    dimension, e.g. ``P("dp", None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _later(what):
    raise MXNetError(f"{what}: tensor, pipeline and sequence parallelism "
                     "(tp, pp, sp above 1) are slice 22 of the port; this "
                     "slice runs data parallelism (dp)")


class Mesh:
    """Named axes over the world's ranks: ``shape`` {axis: size},
    ``devices`` [this process's device], ``group`` the process group of
    the mesh's ranks (None: the whole world, or no group at all), ``rank``
    this process's place in it (None for a stranded rank)."""

    def __init__(self, shape, devices, group=None, rank=0):
        self.shape = dict(shape)
        self.devices = list(devices)
        self.axis_names = tuple(self.shape)
        self.group = group
        self.rank = rank

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(axes, devices=None):
    """A :class:`Mesh` from {'dp': 2, ...} over the world's ranks; this
    process runs on ``devices[0]`` (default: its current device). Every
    rank calls it (a mesh smaller than the world makes a subgroup, a
    collective call). Raises when the product exceeds the world; warns
    and counts ``mesh.unused_devices`` when it undershoots."""
    sizes = {name: int(v) for name, v in axes.items()}
    big = {a: s for a, s in sizes.items() if a != "dp" and s > 1}
    if big:
        _later(f"mesh {sizes}")
    total = math.prod(sizes.values())
    world, rank = _world()
    if total > world:
        raise MXNetError(f"mesh {sizes} needs {total} ranks, have {world} "
                         "(start them with tools/launch.py -n N)")
    unused = world - total
    if unused:
        warnings.warn(
            f"mesh {sizes} uses {total} of {world} ranks; {unused} "
            "stranded (size the axes to the world — MeshConfig "
            "enumerates factorizations)", stacklevel=2)
    if _telemetry.active():
        _telemetry.set_gauge("mesh.unused_devices", unused)
    group = None
    if unused:
        import torch.distributed as dist
        group = dist.new_group(list(range(total)))
    devices = [resolve_device(None)] if devices is None else [
        resolve_device(d) for d in devices]
    return Mesh(sizes, devices[:1], group, rank if rank < total else None)


class MeshConfig:
    """The composed-parallelism entry point: ``dp`` (data), ``tp``
    (tensor), ``pp`` (pipeline), ``sp`` (sequence). All four axes always
    exist in the built mesh (size-1 axes are free), so specs naming any of
    them stay valid on every layout. This slice builds ``dp`` over the
    world's ranks; tp, pp or sp above 1 raise at ``build``."""

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
        """The :class:`Mesh` (raises when the product exceeds the world;
        warns and counts ``mesh.unused_devices`` when it undershoots)."""
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

    def replace(self, **axes):
        """A copy with the named axis sizes substituted, e.g.
        ``cfg.replace(dp=1)``."""
        shape = self.shape
        for name in axes:
            if name not in shape:
                raise MXNetError(
                    f"MeshConfig.replace: unknown axis {name!r}; "
                    f"axes are {self.AXES}")
        shape.update(axes)
        return MeshConfig(**shape)

    def __repr__(self):
        return (f"MeshConfig(dp={self.dp}, tp={self.tp}, pp={self.pp}, "
                f"sp={self.sp})")

    def __eq__(self, other):
        return isinstance(other, MeshConfig) and self.shape == other.shape

    def __hash__(self):
        return hash(tuple(self.shape.items()))


def mesh_factorizations(n_devices=None, max_sp=1):
    """Every MeshConfig whose dp*tp*pp*sp product is exactly
    ``n_devices`` (default: the world size), sp bounded by ``max_sp``."""
    if n_devices is None:
        n_devices = _world()[0]
    n_devices = int(n_devices)
    out = []
    for dp in range(1, n_devices + 1):
        if n_devices % dp:
            continue
        rem = n_devices // dp
        for tp in range(1, rem + 1):
            if rem % tp:
                continue
            rem2 = rem // tp
            for pp in range(1, rem2 + 1):
                if rem2 % pp:
                    continue
                sp = rem2 // pp
                if sp > max_sp:
                    continue
                out.append(MeshConfig(dp=dp, tp=tp, pp=pp, sp=sp))
    return out


def data_parallel_mesh(n=None, devices=None):
    """A {'dp': n} mesh, n defaulting to the world size."""
    return make_mesh({"dp": n or _world()[0]}, devices)


def set_mesh(mesh):
    global _current
    _current = mesh
    return mesh


def current_mesh():
    return _current


def _dp_dim(spec):
    """The dimension of ``spec`` that names 'dp' (None: replicated)."""
    for i, e in enumerate(tuple(spec)):
        if e == "dp" or (isinstance(e, tuple) and "dp" in e):
            return i
    return None


def shard(array, mesh, spec):
    """This rank's part of ``array`` under ``spec`` on ``mesh``: the
    dimension named 'dp' cut into the axis size's equal blocks (the whole
    array where no dimension is). Any other axis above 1 raises."""
    spec = spec if isinstance(spec, P) else P(*spec)
    for e in spec:
        for name in (e if isinstance(e, tuple) else (e,)):
            if name not in (None, "dp") and int(mesh.shape.get(name, 1)) > 1:
                _later(f"shard over {name!r}")
    raw = getattr(array, "_data", array)
    dim = _dp_dim(spec)
    n = int(mesh.shape.get("dp", 1))
    if dim is not None and n > 1:
        if raw.shape[dim] % n:
            raise MXNetError(f"shard: dim {dim} ({raw.shape[dim]}) does not "
                             f"divide by dp={n}")
        k = raw.shape[dim] // n
        raw = raw.narrow(dim, mesh.rank * k, k) if isinstance(
            raw, torch.Tensor) else raw.take(
                range(mesh.rank * k, (mesh.rank + 1) * k), axis=dim)
    if hasattr(array, "_data"):
        from ..numpy.multiarray import _wrap
        return _wrap(raw)
    return raw


def replicate(array, mesh):
    """Every rank holds the whole array: ``array`` itself."""
    return shard(array, mesh, P())
