"""Collectives over the process group.

Counterpart of ``mxnet_tpu/parallel/collectives.py`` (reference:
src/kvstore/comm.h reduce + broadcast, kvstore_nccl.h, ps-lite's
cross-host path). The reference is one program over a mesh and takes a
per-rank stack (leading dim = the axis size); here every process is one
rank, so each function takes THIS rank's row and returns THIS rank's
result:

- :func:`allreduce` — the sum / max / min / mean over the axis;
- :func:`allgather` — the ranks' blocks concatenated along dim 0
  (``tiled``) or stacked;
- :func:`reduce_scatter` — this rank's dim-0 chunk of the sum;
- :func:`ppermute` — the block sent to this rank by the ``(src, dst)``
  pairs of ``perm`` (zeros where none is);
- :func:`compressed_allreduce` — the error-feedback int8 / bf16 mean with
  its residual;
- :func:`allreduce_across_processes` — the sum over every process, and
  :func:`start_allreduce`, the same issued without waiting
  (:func:`wait_work` waits for it with a deadline).

A mesh (``parallel.mesh.Mesh``) names the group; None is the whole
world. With no process group (a world of one) each function is the
reference's on one device: the identity, or its one-rank arithmetic.

Transport is chosen by backend and op before the call, never by catching
an error: NCCL takes CUDA tensors for every op; gloo takes CPU tensors
for every op and CUDA tensors for ``all_reduce`` and ``broadcast`` only
(the others are staged through pinned host buffers: copy out, run on the
host copy, copy back). On gloo a reduce-scatter is an all-reduce and a
copy of this rank's slice (the call gloo runs on every torch this port
meets). ``donate=True`` lets the all-reduce and the reduce-scatter work
in the caller's buffer instead of a copy.

Global-batch statistics: the reference's BatchNorm on a dp mesh reduces
over the whole global batch (GSPMD, ``tests/test_parallel.py:420``). Here
each rank sees only its shard, so inside :func:`sync_batch_stats`
(``ShardedTrainStep``'s forward at dp > 1; the forward of a
``SyncBatchNorm``, or of a BatchNorm whose parameters a Trainer over a
dist store updates) ``npx.batch_norm`` and kernel 8's forward and stats
pass sum their per-channel sums over the group
(:func:`batch_stats_group`; one rank's group is the identity, so each has
one sum-then-divide path).
"""
from __future__ import annotations

import contextlib
import datetime
import time

import torch

from .. import _dist_init
from ..base import MXNetError

__all__ = ["allreduce", "allgather", "reduce_scatter", "ppermute",
           "broadcast",
           "compressed_allreduce", "allreduce_across_processes",
           "start_allreduce", "wait_work",
           "sync_batch_stats", "batch_stats_group", "StatsGroup", "timing"]

#: ops gloo runs on CUDA tensors itself; the rest are staged through host
_GLOO_CUDA_NATIVE = frozenset({"all_reduce", "broadcast"})


def _dist():
    """torch.distributed while a group is up and usable, else None (a
    given-up group raises: ``_dist_init.abandon``)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    _dist_init.check_usable()
    return dist


def _group_of(mesh, axis):
    """(group, size, this rank's coordinate) of ``axis`` on ``mesh`` (None:
    the world): the process group of this rank's line of ranks along the
    axis (None for the whole world)."""
    dist = _dist()
    if mesh is not None:
        if axis not in mesh.shape:
            raise MXNetError(f"mesh has no axis {axis!r}: {mesh.shape}")
        n = int(mesh.shape[axis])
        if dist is None or n == 1:
            return None, 1, 0
        return mesh.axis_group(axis), n, mesh.axis_index(axis)
    if dist is None:
        return None, 1, 0
    return None, dist.get_world_size(), dist.get_rank()


def _staged(op, t, group):
    """Whether ``op`` on ``t`` goes through a host copy: gloo with a CUDA
    tensor for an op gloo does not run on the card."""
    dist = _dist()
    return (t.is_cuda and dist.get_backend(group) == "gloo"
            and op not in _GLOO_CUDA_NATIVE)


def _host(t):
    """A pinned host copy of ``t`` (finished before it is read)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return h


_REDUCE = {"sum": "SUM", "max": "MAX", "min": "MIN", "mean": "SUM"}

#: the dict :func:`timing` fills, or None
_timing = [None]


@contextlib.contextmanager
def timing():
    """Within: every collective of this module waits for its device's
    queued work first, then adds its wall seconds, its count and this
    rank's payload bytes to the yielded dict ``{op: [seconds, calls,
    bytes]}`` (for measurement; off, a collective pays nothing)."""
    prev = _timing[0]
    _timing[0] = out = {}
    try:
        yield out
    finally:
        _timing[0] = prev


@contextlib.contextmanager
def _timed(op, t):
    rec = _timing[0]
    if rec is None:
        yield
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    row = rec.setdefault(op, [0.0, 0, 0])
    row[0] += time.perf_counter() - t0
    row[1] += 1
    row[2] += t.numel() * t.element_size()


def _all_reduce(t, op, group, n):
    """All-reduce ``t`` (a fresh tensor, reduced in place) and return it."""
    dist = _dist()
    with _timed("all_reduce", t):
        dist.all_reduce(t, op=getattr(dist.ReduceOp, _REDUCE[op]),
                        group=group)
    return t / n if op == "mean" else t


def allreduce(x, mesh=None, axis="dp", op="sum", donate=False):
    """``op`` ("sum", "max", "min", "mean") of this rank's ``x`` over
    ``axis``; every rank gets the same result. ``donate``: ``x`` (a
    contiguous buffer the caller gives up) is reduced in place."""
    if op not in _REDUCE:
        raise MXNetError(f"allreduce op must be one of {sorted(_REDUCE)}, "
                         f"got {op!r}")
    group, n, _ = _group_of(mesh, axis)
    if n == 1:
        return x if donate else x.clone()
    return _all_reduce(x.detach() if donate else x.detach().clone(), op,
                       group, n)


def allgather(x, mesh=None, axis="dp", tiled=True):
    """The ranks' ``x`` in rank order: concatenated along dim 0 when
    ``tiled``, else stacked on a new leading dim."""
    group, n, _ = _group_of(mesh, axis)
    if n == 1:
        return x.clone() if tiled else x[None].clone()
    dist = _dist()
    x = x.detach().contiguous()
    shape = tuple(x.shape)
    x = x.reshape((1,) + shape) if x.ndim == 0 else x
    staged = _staged("all_gather", x, group)
    src = _host(x) if staged else x
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=src.device, pin_memory=staged)
    with _timed("all_gather", x):
        dist.all_gather_into_tensor(out, src, group=group)
    if staged:
        out = out.to(x.device, non_blocking=True)
    return out if tiled and shape else out.reshape((n,) + shape)


def reduce_scatter(x, mesh=None, axis="dp", donate=False):
    """This rank's dim-0 chunk of the sum of the ranks' ``x`` (dim 0 must
    divide by the axis size). ``donate``: ``x`` (a contiguous buffer the
    caller gives up) may be reduced in place."""
    group, n, r = _group_of(mesh, axis)
    if x.shape[0] % n:
        raise MXNetError(f"reduce_scatter: dim 0 ({x.shape[0]}) does not "
                         f"divide by the axis size {n}")
    if n == 1:
        return x if donate else x.clone()
    dist = _dist()
    x = x.detach().contiguous()
    k = x.shape[0] // n
    if dist.get_backend(group) == "gloo":
        full = _all_reduce(x if donate else x.clone(), "sum", group, n)
        # a copy of the chunk: the full buffer is not kept alive by it
        return full[r * k:(r + 1) * k].clone()
    out = torch.empty((k,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with _timed("reduce_scatter", x):
        dist.reduce_scatter_tensor(out, x, group=group)
    return out


def ppermute(x, mesh, axis, perm):
    """The block that ``perm``'s ``(src, dst)`` pairs send to this rank,
    zeros where no pair ends here (reference: ``jax.lax.ppermute``)."""
    group, n, r = _group_of(mesh, axis)
    x = x.detach().contiguous()
    if n == 1:
        return x.clone() if (0, 0) in [tuple(p) for p in perm] \
            else torch.zeros_like(x)
    dist = _dist()
    staged = _staged("send", x, group)
    # a rank that only receives reads nothing of x but its shape
    sends = any(src == r for src, _ in perm)
    send = _host(x) if staged and sends else x
    recv = torch.zeros(x.shape, dtype=x.dtype,
                       device="cpu" if staged else x.device,
                       pin_memory=staged)
    ops = []
    for src, dst in perm:
        if src == r and dst == r:
            recv.copy_(send)
        elif src == r:
            ops.append(dist.P2POp(dist.isend, send, _peer(group, dst),
                                  group=group))
        elif dst == r:
            ops.append(dist.P2POp(dist.irecv, recv, _peer(group, src),
                                  group=group))
    with _timed("ppermute", x):
        for w in (dist.batch_isend_irecv(ops) if ops else []):
            w.wait()
    return recv.to(x.device) if staged else recv


def _peer(group, r):
    """The global rank of rank ``r`` of ``group``."""
    dist = _dist()
    return r if group is None else dist.get_global_rank(group, r)


def broadcast(x, mesh, axis, src):
    """The ``x`` of the rank at coordinate ``src`` on ``axis``, on every
    rank of the line (a copy; ``x`` gives the shape and dtype elsewhere)."""
    group, n, _ = _group_of(mesh, axis)
    out = x.detach().contiguous().clone()
    if n == 1:
        return out
    dist = _dist()
    with _timed("broadcast", out):
        dist.broadcast(out, _peer(group, src), group=group)
    return out


def compressed_allreduce(x, mesh=None, axis="dp", mode="int8",
                         residual=None):
    """Error-feedback compressed mean of this rank's ``x`` over ``axis``:
    ``(mean, new_residual)``.

    ``x + residual`` is quantized against a scale shared by the ranks (the
    max over ranks of its absmax, / 127) to int8, or rounded to bf16; the
    payloads move at that width (all-gathered, then summed exactly: int8
    in int32, bf16 in fp32 in rank order), and ``new_residual`` carries
    what the quantization left out into the next call (EF-SGD). The int8
    result is the reference's bit for bit: an exact integer sum, times
    the scale, over the axis size."""
    if mode not in ("int8", "bf16"):
        raise ValueError(f"mode must be 'int8' or 'bf16', got {mode!r}")
    group, n, _ = _group_of(mesh, axis)
    c = x.detach().to(torch.float32)
    if residual is not None:
        c = c + residual
    if mode == "int8":
        amax = torch.max(torch.abs(c)).reshape(1)
        if n > 1:
            amax = _all_reduce(amax, "max", group, n)
        s = amax[0] / 127.0
        s = torch.where(s > 0.0, s, torch.ones_like(s))
        q = torch.clamp(torch.round(c / s), -127.0, 127.0)
        sent = q * s
        wire = q.to(torch.int8)
        total = (allgather(wire.reshape(1, -1), mesh, axis, tiled=True)
                 .to(torch.int32).sum(dim=0) if n > 1
                 else wire.reshape(-1).to(torch.int32))
        red = total.reshape(c.shape).to(torch.float32) * s / n
    else:
        wire = c.to(torch.bfloat16)
        sent = wire.to(torch.float32)
        if n > 1:
            rows = allgather(wire.reshape(1, -1), mesh, axis, tiled=True)
            total = rows[0].to(torch.float32)
            for i in range(1, n):
                total = total + rows[i].to(torch.float32)
            red = total.reshape(c.shape) / n
        else:
            red = sent / n
    return red, c - sent


def start_allreduce(x):
    """Issue the sum of every process's ``x`` without waiting for it:
    ``(work, out)``, ``out`` holding the sum once ``work`` has completed
    (``work.wait()`` orders the device's stream after it); ``(None, a
    copy of x)`` on a world of one. all_reduce runs on CUDA tensors under
    gloo too, so nothing is staged."""
    group, n, _ = _group_of(None, "dp")
    out = x.detach().clone()
    if n == 1:
        return None, out
    dist = _dist()
    return dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group,
                           async_op=True), out


def wait_work(work, timeout):
    """Wait up to ``timeout`` seconds for ``work`` (an async collective of
    the world's group, None: nothing to wait for): True once it has
    completed (its error raised), False when the time ran out with it
    still in flight. gloo blocks in its own timed wait, which leaves the
    collective running; other backends are polled (NCCL's timed wait
    aborts its communicator)."""
    if work is None:
        return True
    dist = _dist()
    if dist is not None and dist.get_backend() == "gloo":
        try:
            work.wait(datetime.timedelta(seconds=timeout))
        except RuntimeError:
            if not work.is_completed():
                return False
            raise
        return True
    deadline = time.monotonic() + timeout
    nap = 5e-5
    while not work.is_completed():
        if time.monotonic() > deadline:
            return False
        time.sleep(nap)
        nap = min(2 * nap, 1e-3)
    work.wait()
    return True


def allreduce_across_processes(x):
    """The sum of every process's ``x`` (the reference's DCN path of the
    dist store); ``x`` itself on a world of one."""
    return allreduce(x, None, "dp", "sum")


# -- global-batch statistics -------------------------------------------------

class StatsGroup:
    """The ``size`` ranks whose per-channel batch statistics are summed
    together: :meth:`sum` is the (non-differentiable) sum over them,
    :meth:`gsum` the differentiable one (its backward sums the cotangents
    too). One rank: each is the identity."""

    def __init__(self, group=None, size=1):
        self.group = group
        self.size = size

    def sum(self, t):
        if self.size == 1:
            return t
        out = t.detach().contiguous().clone()
        _dist().all_reduce(out, group=self.group)
        return out

    def gsum(self, t):
        return t if self.size == 1 else _GlobalSum.apply(t, self)


class _GlobalSum(torch.autograd.Function):
    """All-reduce sum whose backward all-reduces the cotangent: the
    gradient of a sum of every rank's loss through the shared statistic."""

    @staticmethod
    def forward(ctx, t, stats):
        ctx.stats = stats
        return stats.sum(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.stats.sum(g), None


#: each rank's own batch
_LOCAL = StatsGroup()
#: the open :func:`sync_batch_stats` scopes, innermost last (process-wide:
#: a forward reads it; the backward keeps the group its forward saw)
_stats = []


def batch_stats_group():
    """The :class:`StatsGroup` BatchNorm sums its statistics over now
    (one rank, each rank's own batch, outside :func:`sync_batch_stats`)."""
    return _stats[-1] if _stats else _LOCAL


@contextlib.contextmanager
def sync_batch_stats(mesh=None, axis="dp"):
    """Inside: BatchNorm's training statistics are those of the batch of
    every rank of ``axis`` (no-op on a world of one). Every rank's batch
    has the same size (a dp shard), so a statistic's count is this rank's
    times the ranks."""
    group, n, _ = _group_of(mesh, axis)
    if n == 1:
        yield
        return
    _stats.append(StatsGroup(group, n))
    try:
        yield
    finally:
        _stats.pop()
