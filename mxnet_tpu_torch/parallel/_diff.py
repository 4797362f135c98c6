"""Differentiable collectives: each a ``torch.autograd.Function`` whose
backward is its forward's transpose.

The reference lays one program over a GSPMD mesh and XLA inserts the
collectives, with their transposes in the backward. Here every rank is one
process, so each is written out, over the process group of one mesh axis
(``parallel.collectives``). Two conventions of what a rank's cotangent
means, by axis:

- tensor parallelism (Megatron): a tensor replicated over the axis has
  the same value AND the same, whole cotangent on every rank of it (the
  loss is replicated too). :func:`copy_to` (identity; all-reduce in the
  backward) enters a shard-local computation, :func:`reduce_from`
  (all-reduce; identity) leaves it, :func:`gather` (all-gather; this
  rank's slice of the cotangent) makes a shard's replicated whole.
- sequence and pipeline parallelism: each rank's loss is its own part of
  the objective, the sum over ranks, so a rank's cotangent is its share:
  :func:`gather_partial` (all-gather; reduce-scatter), :func:`permute`
  (ppermute; the inverse ppermute), :func:`broadcast` (from a source;
  the cotangents summed to the source, zeros elsewhere, or with
  ``replicated=True`` the source's own cotangent).

Every rank of the axis must run the same collectives in the same order,
forward and backward; the graphs the layers build are alike on every rank,
so autograd visits them alike.
"""
from __future__ import annotations

import torch

from . import collectives as _coll

__all__ = ["copy_to", "reduce_from", "gather", "gather_partial",
           "permute", "broadcast"]


def _size(mesh, axis):
    return _coll._group_of(mesh, axis)[1:]


def _gather_dim(x, mesh, axis, dim):
    """All-gather of ``x`` along ``dim`` in axis order."""
    xt = x.movedim(dim, 0).contiguous()
    return _coll.allgather(xt, mesh, axis, tiled=True).movedim(0, dim)


def _scatter_dim(x, mesh, axis, dim):
    """This rank's block along ``dim`` of the sum of the ranks' ``x``."""
    xt = x.movedim(dim, 0).contiguous()
    return _coll.reduce_scatter(xt, mesh, axis).movedim(0, dim)


def _slice_dim(x, mesh, axis, dim):
    n, r = _size(mesh, axis)
    k = x.shape[dim] // n
    return x.narrow(dim, r * k, k).contiguous()


def _allreduce(x, mesh, axis):
    return _coll.allreduce(x.contiguous(), mesh, axis, "sum")


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _allreduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _allreduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather_dim(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice_dim(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather_dim(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_scatter_dim(g, ctx.mesh, ctx.axis, ctx.dim), None, None,
                None)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.inverse = [(d, s) for s, d in perm]
        return _coll.ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return (_coll.ppermute(g.contiguous(), ctx.mesh, ctx.axis,
                               ctx.inverse), None, None, None)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, src, replicated):
        ctx.mesh, ctx.axis, ctx.src = mesh, axis, src
        ctx.replicated = replicated
        return _coll.broadcast(x, mesh, axis, src)

    @staticmethod
    def backward(ctx, g):
        _, r = _size(ctx.mesh, ctx.axis)
        if not ctx.replicated:
            g = _allreduce(g, ctx.mesh, ctx.axis)
        g = g if r == ctx.src else torch.zeros_like(g)
        return g, None, None, None, None


def copy_to(x, mesh, axis):
    """``x`` (replicated over ``axis``) entering a shard-local computation:
    the identity, its backward the all-reduce of the partial cotangents."""
    return x if _size(mesh, axis)[0] == 1 else _CopyTo.apply(x, mesh, axis)


def reduce_from(x, mesh, axis):
    """The sum over ``axis`` of the ranks' partial ``x``, replicated; the
    backward passes the (replicated) cotangent through."""
    return x if _size(mesh, axis)[0] == 1 else _ReduceFrom.apply(x, mesh,
                                                                 axis)


def gather(x, mesh, axis, dim):
    """The ranks' blocks along ``dim`` concatenated, replicated; the
    backward takes this rank's block of the replicated cotangent."""
    return x if _size(mesh, axis)[0] == 1 else _Gather.apply(x, mesh, axis,
                                                             dim)


def gather_partial(x, mesh, axis, dim):
    """The ranks' blocks along ``dim`` concatenated, each rank using them
    for its own share of the objective; the backward reduce-scatters the
    ranks' cotangents (this rank's block of their sum)."""
    if _size(mesh, axis)[0] == 1:
        return x
    return _GatherPartial.apply(x, mesh, axis, dim)


def permute(x, mesh, axis, perm):
    """``collectives.ppermute`` (zeros where no pair ends here); the
    backward sends the cotangents back along the inverse pairs."""
    return _Permute.apply(x, mesh, axis, [tuple(p) for p in perm])


def broadcast(x, mesh, axis, src, replicated=False):
    """The ``x`` of coordinate ``src`` on every rank of ``axis``. The
    backward sums the ranks' cotangents to ``src`` (zeros elsewhere); with
    ``replicated`` (every rank's cotangent is the same whole one) it keeps
    the source's own."""
    if _size(mesh, axis)[0] == 1:
        return x
    return _Broadcast.apply(x, mesh, axis, int(src), bool(replicated))
