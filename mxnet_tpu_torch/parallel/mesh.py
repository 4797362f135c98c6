"""Device meshes over the process group.

Counterpart of ``mxnet_tpu/parallel/mesh.py``: ``make_mesh``,
``MeshConfig``, ``mesh_factorizations``, ``data_parallel_mesh``,
``set_mesh`` / ``current_mesh``, ``shard`` / ``replicate`` and the
activation-sharding scope (``activation_sharding``, ``constrain``). The
reference lays a mesh over devices of one program; here a mesh is the
world's ranks (one process each, ``torch.distributed``) under named axes,
with the device this process runs on.

Rank r sits where the reference's device r sits: the ranks fill the axes
row-major in the order they are given (``MeshConfig`` gives
``('dp', 'pp', 'sp', 'tp')``, tp innermost), so a rank's coordinate on
each axis is its index unravelled over the axis sizes. Every axis above 1
has a process group per line of ranks along it (the ranks that share
every other coordinate); ``Mesh.axis_group(axis)`` is this rank's and
``Mesh.axis_index(axis)`` its place in it. ``dist.new_group`` is a
collective call over the whole world, so every rank creates every
subgroup, in the same order, those it is no member of included (a rank
that skipped one would hang the others); groups are kept by their ranks
and made once a process.

A mesh whose axis product undershoots the world strands the rest of the
ranks: it warns and sets the ``mesh.unused_devices`` gauge, as the
reference does. ``P`` is the port's stand-in for JAX's
``PartitionSpec``: a tuple of axis names (or None, or a tuple of names)
per array dimension.

Activation sharding: the reference's layers call ``constrain(x, kind)``
and XLA moves data to the rule's layout. Here every rank already holds
its own shard of an activation (a residual's sequence rows under sp), so
``constrain`` changes no value: it checks the local length of the
dimension the rule shards over 'sp' against the one the training step
expects (``activation_sharding(..., local={'sp': s})``) and raises on a
mismatch.
"""
from __future__ import annotations

import math
import warnings

import numpy as onp
import torch

from .. import telemetry as _telemetry
from ..base import MXNetError
from ..context import resolve_device

__all__ = ["P", "Mesh", "make_mesh", "MeshConfig", "mesh_factorizations",
           "data_parallel_mesh", "set_mesh", "current_mesh", "shard",
           "replicate", "activation_sharding", "constrain", "sp_axis"]

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


#: process groups by their tuple of global ranks, made once a process
_GROUPS = {}


def _group(ranks):
    """The process group of ``ranks`` (a tuple of global ranks); None for
    the whole world. Every rank must ask for the same groups in the same
    order: ``new_group`` is collective over the world."""
    world, _ = _world()
    if len(ranks) == world and tuple(ranks) == tuple(range(world)):
        return None
    g = _GROUPS.get(ranks)
    if g is None:
        import torch.distributed as dist
        g = _GROUPS[ranks] = dist.new_group(list(ranks))
    return g


class Mesh:
    """Named axes over the world's ranks: ``shape`` {axis: size},
    ``devices`` [this process's device], ``group`` the process group of
    the mesh's ranks (None: the whole world, or no group at all), ``rank``
    this process's place in it (None for a stranded rank), ``coords`` its
    coordinate on each axis."""

    def __init__(self, shape, devices, group=None, rank=0, coords=None,
                 groups=None):
        self.shape = dict(shape)
        self.devices = list(devices)
        self.axis_names = tuple(self.shape)
        self.group = group
        self.rank = rank
        self.coords = dict(coords) if coords is not None else {
            a: 0 for a in self.shape}
        self._groups = dict(groups or {})

    def axis_index(self, axis):
        """This rank's coordinate on ``axis`` (a name, or a tuple of names
        taken row-major)."""
        if isinstance(axis, tuple):
            idx = 0
            for a in axis:
                idx = idx * int(self.shape[a]) + self.coords[a]
            return idx
        if axis not in self.shape:
            raise MXNetError(f"mesh has no axis {axis!r}: {self.shape}")
        return self.coords[axis]

    def axis_group(self, axis):
        """The process group of this rank's line along ``axis`` (None: the
        whole world, or an axis of size 1)."""
        return self._groups.get(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def make_mesh(axes, devices=None):
    """A :class:`Mesh` from {'dp': 2, 'tp': 2, ...} over the world's
    ranks, row-major in the axes' order; this process runs on
    ``devices[0]`` (default: its current device). Every rank calls it:
    it makes a process group for each line of ranks along each axis above
    1 (collective calls, in one order on every rank). Raises when the
    product exceeds the world; warns and counts ``mesh.unused_devices``
    when it undershoots."""
    sizes = {name: int(v) for name, v in axes.items()}
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
    names = list(sizes)
    grid = onp.arange(total).reshape([sizes[a] for a in names]) \
        if names else onp.arange(total)
    mine = rank if rank < total else None
    coords = ({a: int(c) for a, c in zip(
        names, onp.unravel_index(mine, grid.shape))} if mine is not None
        and names else {a: 0 for a in names})
    groups = {}
    if world > 1:
        for i, axis in enumerate(names):
            if sizes[axis] == 1:
                continue
            # every line along this axis, in one order on every rank
            moved = onp.moveaxis(grid, i, -1).reshape(-1, sizes[axis])
            for line in moved:
                ranks = tuple(int(r) for r in line)
                g = _group(ranks)
                if mine in ranks:
                    groups[axis] = g
    group = _group(tuple(range(total))) if unused else None
    devices = [resolve_device(None)] if devices is None else [
        resolve_device(d) for d in devices]
    return Mesh(sizes, devices[:1], group, mine, coords, groups)


class MeshConfig:
    """The composed-parallelism entry point: ``dp`` (data), ``tp``
    (tensor, Megatron), ``pp`` (pipeline stages), ``sp`` (sequence, ring
    attention). All four axes always exist in the built mesh (size-1 axes
    are free), so specs naming any of them stay valid on every layout. The
    ranks lie on the axes in the order ('dp', 'pp', 'sp', 'tp'), tp
    innermost, as the reference's devices do.

        cfg = MeshConfig(dp=2, tp=2, pp=2)      # 8 ranks
        step = ShardedTrainStep(net, loss_fn, opt, cfg,
                                batch_specs=cfg.batch_specs(2, 2))
    """

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

    def activation_rules(self):
        """The activation-sharding rules the step installs around its
        call: the residual stream's batch over dp and sequence over sp
        (sp > 1), which routes attention to ring attention."""
        if self.sp > 1:
            return {"residual": P("dp", "sp", None)}
        return {}

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


def _names(entry):
    return entry if isinstance(entry, tuple) else (entry,)


def spec_cuts(spec, mesh):
    """[(dim, parts, index)] of ``spec`` on ``mesh``: each dimension named
    by axes above 1, cut into the product of their sizes, and this rank's
    block (the axes row-major)."""
    out = []
    for dim, e in enumerate(tuple(spec)):
        axes = tuple(a for a in _names(e)
                     if a is not None and int(mesh.shape.get(a, 1)) > 1)
        if not axes:
            continue
        for a in axes:
            if a not in mesh.shape:
                raise MXNetError(f"spec {spec} names {a!r}, not an axis of "
                                 f"{mesh.shape}")
        parts = math.prod(int(mesh.shape[a]) for a in axes)
        out.append((dim, parts, mesh.axis_index(axes)))
    return out


def local_part(raw, cuts, lead=0):
    """``raw`` (a tensor or numpy array) cut by ``spec_cuts``, each cut
    dimension offset by ``lead`` leading axes."""
    for dim, parts, idx in cuts:
        dim += lead
        n = raw.shape[dim]
        if n % parts:
            raise MXNetError(f"dim {dim} ({n}) does not divide into {parts} "
                             "parts")
        k = n // parts
        if isinstance(raw, torch.Tensor):
            raw = raw.narrow(dim, idx * k, k)
        else:
            sl = [slice(None)] * raw.ndim
            sl[dim] = slice(idx * k, (idx + 1) * k)
            raw = raw[tuple(sl)]
    return raw


def shard(array, mesh, spec):
    """This rank's part of ``array`` under ``spec`` on ``mesh``: every
    dimension named by axes above 1 cut into their product's equal blocks,
    this rank's by its coordinates (the whole array where no dimension
    is)."""
    spec = spec if isinstance(spec, P) else P(*spec)
    raw = getattr(array, "_data", array)
    cuts = spec_cuts(spec, mesh)
    if not cuts:
        return array
    raw = local_part(raw, cuts)
    if hasattr(array, "_data"):
        from ..numpy.multiarray import _wrap
        return _wrap(raw)
    return raw


def replicate(array, mesh):
    """Every rank holds the whole array: ``array`` itself."""
    return shard(array, mesh, P())


# -- activation sharding (sequence parallelism) -------------------------------
#: (mesh, rules, local lengths) of the innermost activation_sharding scope
_act_rules = None


class activation_sharding:
    """Scope of activation rules the layers consult (reference:
    ``mesh.py`` ``activation_sharding``):

        with parallel.activation_sharding(mesh, residual=P('dp', 'sp', None)):
            out = net(x_local)

    Under a rule whose residual names 'sp' (on a mesh with sp > 1), pure
    self-attention runs as ring attention over the sp ranks, masked
    attention gathers keys and values over them, and GPT / BERT offset
    their positions by this rank's sequence block. ``local``: the local
    lengths the step expects, e.g. ``{'sp': 512}``, which ``constrain``
    checks."""

    def __init__(self, mesh, local=None, **rules):
        self.mesh = mesh
        self.rules = rules
        self.local = dict(local or {})
        self._prev = None

    def __enter__(self):
        global _act_rules
        self._prev = _act_rules
        _act_rules = (self.mesh, self.rules, self.local)
        return self

    def __exit__(self, *exc):
        global _act_rules
        _act_rules = self._prev


def constrain(x, kind):
    """``x`` unchanged (each rank holds its shard already); under a rule
    ``kind`` whose dimension names 'sp', with a local length given to the
    scope, raises when x's length there differs from it."""
    if _act_rules is None:
        return x
    _, rules, local = _act_rules
    spec = rules.get(kind)
    want = local.get("sp")
    if spec is None or want is None:
        return x
    for dim, e in enumerate(tuple(spec)):
        if "sp" in _names(e) and dim < x.ndim and x.shape[dim] != want:
            raise MXNetError(
                f"constrain({kind!r}): dim {dim} of shape {tuple(x.shape)} "
                f"is not this rank's sequence block of {want}")
    return x


def sp_axis():
    """(mesh, size, index) of the sequence axis of the active
    activation_sharding scope when its residual rule names 'sp' and the
    mesh's sp is above 1, else None."""
    if _act_rules is None:
        return None
    mesh, rules, _ = _act_rules
    spec = rules.get("residual")
    n = int(mesh.shape.get("sp", 1))
    if spec is None or n <= 1 or not any(
            "sp" in _names(e) for e in tuple(spec)):
        return None
    return mesh, n, mesh.axis_index("sp")
