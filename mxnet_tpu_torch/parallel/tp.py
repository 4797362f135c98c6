"""Tensor parallelism: Megatron-style Dense layers over a mesh axis.

Counterpart of ``mxnet_tpu/parallel/tp.py``. The reference writes a layout
as PartitionSpecs on the weights and GSPMD keeps every value the same
whatever the specs; here each rank holds its block of a sharded weight
(the Parameter's storage is replaced by it) and its Dense takes a role
that says how the block is used, so the values are the reference's too:

- ``column`` (weight ``P(tp, None)``, bias ``P(tp)`` or replicated): the
  input enters through :func:`_diff.copy_to`, the output is this rank's
  block of the units. Only where a Megatron partner consumes that block:
  the q/k/v projections of a ``MultiHeadAttention`` whose ``out_proj`` is
  a row (the attention then runs ``heads / tp`` local heads), ``ffn_1``
  of a ``PositionwiseFFN`` whose ``ffn_2`` is a row;
- ``row`` (weight ``P(None, tp)``, the partner): the partial products are
  all-reduced (:func:`_diff.reduce_from`), then the replicated bias is
  added once;
- ``column_gather``: a column weight that no partner consumes (a lone
  Dense, ``shard_dense_column``, ``auto_shard_block``'s alternation, any
  user ``param_specs``): its output blocks are all-gathered;
- ``gather``: any other sharded weight (a row without its column, a
  sharded bias elsewhere): the weight (and bias) blocks are all-gathered
  and the product is the whole one.

``megatron_roles`` derives the roles from a block's specs (the training
step's path); ``shard_dense_column`` / ``shard_dense_row`` / ``shard_mlp``
/ ``auto_shard_block`` shard a block in place for use under the mesh
directly, and :func:`unshard` gathers it back whole.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import _diff

__all__ = ["shard_dense_column", "shard_dense_row", "shard_mlp",
           "auto_shard_block", "megatron_roles", "unshard", "TpRole"]


def _names(e):
    return e if isinstance(e, tuple) else (e,)


def tp_dim(spec, axis="tp"):
    """The dimension of ``spec`` naming ``axis`` (None: not sharded over
    it)."""
    for i, e in enumerate(tuple(spec or ())):
        if axis in _names(e):
            return i
    return None


class TpRole:
    """How a Dense runs under tensor parallelism over ``axis`` of ``mesh``
    (``kind``: column, row, column_gather or gather); ``wdim`` the weight
    dimension its storage holds a block of (None: whole), ``bias_block``
    whether the bias storage is a block."""

    def __init__(self, kind, mesh, axis, wdim, bias_block):
        self.kind, self.mesh, self.axis = kind, mesh, axis
        self.wdim, self.bias_block = wdim, bias_block

    def __repr__(self):
        return (f"TpRole({self.kind}, weight dim {self.wdim}, bias block "
                f"{self.bias_block})")

    def run(self, dense, x):
        m, a = self.mesh, self.axis
        w, b = dense.weight, dense.bias
        if self.kind in ("column", "column_gather"):
            # a column's bias is always held as its block of the units
            out = dense._product(_diff.copy_to(x, m, a), w, b)
            if self.kind == "column_gather":
                out = _diff.gather(out, m, a, out.ndim - 1)
            return out
        if self.kind == "row":
            out = _diff.reduce_from(dense._product(x, w, None), m, a)
            if b is not None:
                out = out + (_diff.gather(b, m, a, 0) if self.bias_block
                             else b)
            return out
        if self.wdim is not None:
            w = _diff.gather(w, m, a, self.wdim)
        if b is not None and self.bias_block:
            b = _diff.gather(b, m, a, 0)
        return dense._product(x, w, b)


def _tp_size(mesh, axis):
    return int(mesh.shape.get(axis, 1))


def _block_of(t, mesh, axis, dim):
    n, r = _tp_size(mesh, axis), mesh.axis_index(axis)
    if t.shape[dim] % n:
        raise MXNetError(f"tp={n} does not divide dim {dim} of shape "
                         f"{tuple(t.shape)}")
    k = t.shape[dim] // n
    return t.narrow(dim, r * k, k).contiguous().clone()


@torch.no_grad()
def _take_block(var, mesh, axis, dim):
    """Replace ``var``'s storage (a Parameter's tensor) by this rank's
    block along ``dim``."""
    var._mx_param._replace(_block_of(var.data, mesh, axis, dim))


def _set_role(dense, role, mesh, axis):
    from ..gluon.nn import Dense
    if not isinstance(dense, Dense):
        raise MXNetError(f"tensor parallelism shards Dense layers, got "
                         f"{type(dense).__name__}")
    if dense._tp is not None:
        raise MXNetError(f"{dense!r} is already sharded ({dense._tp})")
    wdim = {"column": 0, "column_gather": 0, "row": 1}.get(role)
    if wdim is not None:
        _take_block(dense.weight, mesh, axis, wdim)
    bias_block = dense.bias is not None and role in ("column",
                                                     "column_gather")
    if bias_block:
        _take_block(dense.bias, mesh, axis, 0)
    dense._tp = TpRole(role, mesh, axis, wdim, bias_block)
    return dense


def shard_dense_column(dense, mesh, axis="tp"):
    """Shard a Dense's units (weight rows, bias) over ``axis``; a lone
    column gathers its output, so its values stay the whole layer's."""
    if _tp_size(mesh, axis) > 1:
        _set_role(dense, "column_gather", mesh, axis)
    return dense


def shard_dense_row(dense, mesh, axis="tp"):
    """Shard a Dense's in_units (weight columns) over ``axis``; without a
    column partner its weight blocks are gathered for the product."""
    if _tp_size(mesh, axis) > 1:
        _take_block(dense.weight, mesh, axis, 1)
        dense._tp = TpRole("gather", mesh, axis, 1, False)
    return dense


def shard_mlp(proj_in, proj_out, mesh, axis="tp"):
    """Megatron MLP: ``proj_in`` column, ``proj_out`` row, one all-reduce
    in the forward (the activation between them is elementwise)."""
    if _tp_size(mesh, axis) > 1:
        _set_role(proj_in, "column", mesh, axis)
        _set_role(proj_out, "row", mesh, axis)


def auto_shard_block(block, mesh, dp_axis="dp", tp_axis=None):
    """The reference's heuristic over ``block``'s initialized Dense
    weights in traversal order: with ``tp_axis``, a 2-D weight whose
    smaller side is at least the axis size and larger side at least 128
    is sharded, alternating column / row; each sharded layer gathers (no
    partner is known), so the values stay the block's. Everything else
    stays replicated."""
    from ..gluon.nn import Dense
    if not tp_axis or _tp_size(mesh, tp_axis) == 1:
        return block
    n = _tp_size(mesh, tp_axis)
    col = True
    for _, m in block.named_modules():
        if not isinstance(m, Dense) or not m.weight._mx_param.initialized:
            continue
        shape = tuple(m.weight.shape)
        if min(shape) >= n and max(shape) >= 128:
            if col:
                shard_dense_column(m, mesh, tp_axis)
            else:
                shard_dense_row(m, mesh, tp_axis)
            col = not col
    return block


@torch.no_grad()
def unshard(block):
    """Gather every sharded Dense of ``block`` back to its whole weight and
    bias (a collective over each one's axis) and clear its role."""
    from ..gluon.nn import Dense
    from . import collectives as _coll
    for _, m in block.named_modules():
        role = getattr(m, "_tp", None) if isinstance(m, Dense) else None
        if role is None:
            continue
        for var, dim in ((m.weight, role.wdim),
                         (m.bias, 0 if role.bias_block else None)):
            if var is None or dim is None:
                continue
            t = var.data.movedim(dim, 0).contiguous()
            full = _coll.allgather(t, role.mesh, role.axis).movedim(0, dim)
            var._mx_param._replace(full.contiguous())
        m._tp = None


# -- the step's path: roles from param specs -----------------------------------

def _is_column(spec, axis):
    return tp_dim(spec, axis) == 0 and len(tuple(spec)) == 2 and all(
        e is None for e in tuple(spec)[1:])


def _is_row(spec, axis):
    return tp_dim(spec, axis) == 1 and len(tuple(spec)) == 2 and \
        tuple(spec)[0] is None


def _bias_ok(spec, axis, column):
    """A bias spec a Megatron half takes: a block of the units (column) or
    replicated."""
    if spec is None or not any(e is not None for e in tuple(spec)):
        return True
    return column and tp_dim(spec, axis) == 0 and len(tuple(spec)) == 1


def megatron_roles(block, specs, mesh, axis="tp"):
    """Shard ``block`` in place by ``specs`` ({structural name: spec}) over
    ``axis`` and give each sharded Dense its role: Megatron pairs inside
    ``MultiHeadAttention`` (local heads) and ``PositionwiseFFN``, every
    other sharded Dense gathering. Raises where tp does not divide the
    heads or the FFN's hidden size, and on a sharded parameter that is not
    a Dense's. Returns {name: (dim, role kind)} of the sharded names."""
    from ..gluon.nn import Dense
    from ..gluon.nn.transformer import MultiHeadAttention, PositionwiseFFN
    n = _tp_size(mesh, axis)
    if n == 1:
        return {}

    def spec(prefix, attr):
        return specs.get(f"{prefix}{attr}")

    def pre(path):
        return f"{path}." if path else ""

    modules = dict(block.named_modules())
    paired = {}
    for path, m in modules.items():
        p = pre(path)
        if isinstance(m, MultiHeadAttention):
            cols = [f"{p}{x}_proj." for x in ("query", "key", "value")]
            if all(_is_column(spec(c, "weight"), axis)
                   and _bias_ok(spec(c, "bias"), axis, True) for c in cols) \
                    and _is_row(spec(f"{p}out_proj.", "weight"), axis) \
                    and _bias_ok(spec(f"{p}out_proj.", "bias"), axis, False):
                if m._heads % n:
                    raise MXNetError(
                        f"tp={n} does not divide the {m._heads} heads of "
                        f"{path or 'the attention'}")
                for c in cols:
                    paired[c[:-1]] = "column"
                paired[f"{p}out_proj"] = "row"
                m._tp_heads = m._heads // n
        elif isinstance(m, PositionwiseFFN):
            if _is_column(spec(f"{p}ffn_1.", "weight"), axis) \
                    and _bias_ok(spec(f"{p}ffn_1.", "bias"), axis, True) \
                    and _is_row(spec(f"{p}ffn_2.", "weight"), axis) \
                    and _bias_ok(spec(f"{p}ffn_2.", "bias"), axis, False):
                hidden = m.ffn_1.weight.shape[0]
                if hidden % n:
                    raise MXNetError(
                        f"tp={n} does not divide the FFN hidden size "
                        f"{hidden} of {path or 'the FFN'}")
                paired[f"{p}ffn_1"] = "column"
                paired[f"{p}ffn_2"] = "row"
    out = {}
    dense_params = set()
    for path, m in modules.items():
        if not isinstance(m, Dense):
            continue
        p = pre(path)
        wspec, bspec = spec(p, "weight"), spec(p, "bias")
        dense_params.update({f"{p}weight", f"{p}bias"})
        wdim = tp_dim(wspec, axis)
        bdim = tp_dim(bspec, axis) if m.bias is not None else None
        if wdim is None and bdim is None:
            continue
        kind = paired.get(path)
        if kind is None:
            kind = "column_gather" if _is_column(wspec, axis) and \
                _bias_ok(bspec, axis, True) else "gather"
        if kind in ("column", "column_gather", "row"):
            _set_role(m, kind, mesh, axis)
        else:
            if wdim is not None:
                _take_block(m.weight, mesh, axis, wdim)
            if bdim is not None:
                _take_block(m.bias, mesh, axis, bdim)
            m._tp = TpRole("gather", mesh, axis, wdim, bdim is not None)
        role = m._tp
        out[f"{p}weight"] = (role.wdim, role.kind)
        if m.bias is not None and role.bias_block:
            out[f"{p}bias"] = (0, role.kind)
    for name, s in specs.items():
        if tp_dim(s, axis) is not None and name not in dense_params:
            raise MXNetError(
                f"param_specs shards {name!r} over {axis!r}: tensor "
                "parallelism shards Dense weights and biases only")
    return out


def clear_roles(block):
    """Drop every Dense's role and the attention's local head count
    (storage untouched: :func:`unshard` gathers it)."""
    from ..gluon.nn import Dense
    from ..gluon.nn.transformer import MultiHeadAttention
    for _, m in block.named_modules():
        if isinstance(m, Dense):
            m._tp = None
        elif isinstance(m, MultiHeadAttention):
            m._tp_heads = None
