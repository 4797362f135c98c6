"""``HybridBlock.hybridize()``: a hybridized block's calls as CUDA graphs.

Counterpart of ``_CachedGraph`` in ``mxnet_tpu/gluon/block.py``, where a
hybridized forward is one ``jax.jit`` per (block, train mode) keyed by its
input signature. Here one :class:`_CachedGraph` per block keeps one
entry per signature:

- the key: whether the call records (``autograd`` recording, grad mode
  on, and an input or a trainable parameter that requires grad) and
  ``autograd.is_training()``; the (args, kwargs) tree, each non-tensor
  leaf by its ``repr`` (digested past 128 characters) and each tensor by
  shape, dtype, device and ``requires_grad``; the AMP policy (active,
  target dtype); and the route knobs a forward reads (``fused_conv_bn``,
  ``fused_ln_residual``, ``quantize.fused_matmul``), which a capture bakes
  in. At most ``cached_graph.max_signatures`` entries are kept, the least
  recently used dropped first (with their graphs and memory pools).
- On a CUDA block an entry is captured at its first call: warm-up calls
  run eagerly on the capture stream (kernel builds, cuBLAS workspaces, the
  ln_residual backward's per-stream tickets), the aux parameters
  (``grad_req="null"``: BatchNorm's running statistics) and the dropout
  generators are put back as they were, one ``torch.cuda.CUDAGraph`` of
  the forward is captured from static input buffers, and, when the call
  records, a second graph of ``torch.autograd.grad`` of the outputs with
  respect to the trainable parameters and the inputs that require grad,
  from static cotangent buffers. The capture differentiates with respect
  to aliases of the trainable parameters (fresh leaves over their
  storage, which the forward reads in their place), so an eager graph
  still alive over the parameters, whose gradient accumulators belong to
  the default stream, cannot draw the capture onto that stream. The
  cyclic garbage collector is paused while an entry captures: a dead
  block's graphs collected mid-capture would invalidate it. A call
  copies its inputs in, replays,
  and returns copies of the outputs, so a later call never overwrites an
  earlier result. A recording call is one ``torch.autograd.Function``
  whose backward replays the second graph and returns the gradients, so
  ``autograd.backward``'s ``grad_req`` rules decide what lands in
  ``.grad``. Aux state is updated in place inside the graph, as it is
  eagerly; every generator a forward draws from (``random.dropout_mask``)
  is registered with the graph, so each replay draws fresh masks and
  advances it as an eager call does.
- An entry whose parameters' storage changed (``Parameter.cast``,
  ``reset_ctx``, a deferred shape made known: ``Parameter.
  _storage_version``, or a tensor whose address moved) is dropped and
  captured again. In-place writes (the Trainer, ``set_data`` on a known
  shape) keep the storage, and replays see them.
- Inside an outermost hybridized call (or ``functional.functional_call``)
  every block runs its plain forward: one graph per outermost call.
- A lock per :class:`_CachedGraph` serializes the calls and backward
  replays that share its static buffers, and an event recorded after each
  replay makes the next one wait on the device too (callers on other
  streams). A recorded call whose backward
  has not run yet holds its entry: calling the same entry again under
  ``record()`` before that raises, as its saved activations would be
  overwritten.
- On the CPU the same cache, key and invalidation logic run the forward
  eagerly. On a CUDA block a capture or replay that fails raises with its
  reason; nothing runs the eager forward in its place.
- The host planes, as the reference's ``_CachedGraph`` feeds them
  (``mxnet_tpu/gluon/block.py:420-552``): a ``CachedOp:<block>`` profiler
  span on every call (``profile_symbolic``); ``cached_graph.
  cache_hit_total`` / ``cache_miss_total``; for each new entry
  ``telemetry.note_compile`` with the capture's seconds (the recompile
  detector) and ``insight.capture_jit`` of its cost, counted on the
  warm-up run (``insight.count``). The reference counts a block's ops
  once per traced signature, so the ops of the run that makes an entry
  count (``_hooks.tracing``: the warm-up on the card, the first call on
  the CPU, where an injected ``invoke.nan_output`` is probed and applies
  nothing) and no other run's do (``_hooks.silent``: the capture, and on
  the CPU every later call of the signature).
"""
from __future__ import annotations

import collections
import contextlib
import gc
import hashlib
import threading
import time
import weakref

import numpy as onp
import torch
from torch.utils import _pytree as pytree

from .. import _hooks
from .. import amp as _amp
from .. import autograd as _autograd
from .. import config as _config
from .. import insight as _insight
from .. import profiler as _profiler
from .. import random as _random
from .. import telemetry as _telemetry
from ..base import MXNetError

__all__ = ["plain_scope", "in_plain_scope"]

#: the route knobs a forward reads; a capture bakes their values in
_ROUTE_KNOBS = ("fused_conv_bn", "fused_ln_residual",
                "quantize.fused_matmul")

_tls = threading.local()
#: one capture at a time in the process: captures share a stream per device
_capture_lock = threading.Lock()
_capture_streams: dict[int, torch.cuda.Stream] = {}


@contextlib.contextmanager
def plain_scope():
    """Within the scope (this thread) hybridized blocks run their plain
    forward."""
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _tls.depth -= 1


def in_plain_scope():
    return getattr(_tls, "depth", 0) > 0


def _without_outputs(cost):
    """A cost dict without the outputs a count read (mx.insight off: the
    bare dict the run filled), so an entry keeps no warm-up tensor."""
    return {k: v for k, v in cost.items() if k != "outputs"}


class _Arr:
    """Marks a tensor leaf in a signature's static leaves."""

    def __repr__(self):
        return "A"


_ARR = _Arr()


def _static_repr(leaf):
    """Signature token of a non-tensor leaf; long reprs are digested."""
    r = repr(leaf)
    if len(r) > 128:
        return "H" + hashlib.sha256(r.encode()).hexdigest()
    return r


def _alias(param):
    """A leaf over ``param``'s storage that requires grad (a new tensor
    object: no autograd history, no gradient accumulator), carrying the
    back-reference layers read."""
    alias = param._var.detach().requires_grad_(True)
    alias._mx_param = param
    return alias


@contextlib.contextmanager
def _substituted(block, aliases):
    """Within the scope every module of ``block`` that holds a tensor of
    ``aliases`` ({parameter tensor: alias}) holds its alias instead (tied
    parameters included); put back on exit."""
    swapped = []
    if aliases:
        for module in block.modules():
            for name, t in module._parameters.items():
                alias = aliases.get(t) if t is not None else None
                if alias is not None:
                    swapped.append((module, name, t))
                    module._parameters[name] = alias
    try:
        yield
    finally:
        for module, name, t in swapped:
            module._parameters[name] = t


@contextlib.contextmanager
def _gc_paused():
    """No cyclic garbage collection within the scope: a collection during
    a capture can free another block's captured graphs (a block and its
    ``_CachedGraph`` form a cycle), and destroying a graph executable
    while a stream captures invalidates that capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _capture_stream(device):
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = _capture_streams.get(index)
    if stream is None:
        stream = _capture_streams[index] = torch.cuda.Stream(index)
    return stream


class _Entry:
    """One signature: the parameters' storage it was made against and, on
    a CUDA block, its graphs and static buffers."""

    def __init__(self, params):
        self.storage = [(p, p._storage_version, p._var.data_ptr())
                        for p in params]
        self.out_spec = None
        self.fwd = self.bwd = None
        #: seconds of the warm-up and capture, on a CUDA block
        self.capture_s = 0.0
        self.pending = None  # weakref to the node of an unfinished record
        #: the cost counted on the run that made the entry, while
        #: mx.insight is on ({} otherwise)
        self.cost = {}

    def cost_analysis(self):
        """The counted cost under XLA's keys (``insight.capture_cost``)."""
        return {"flops": self.cost.get("flops"),
                "bytes accessed": self.cost.get("bytes_accessed"),
                "bytes accessedout{}": self.cost.get("output_bytes")}

    def stale(self):
        return any(p._storage_version != v or p._var.data_ptr() != ptr
                   for p, v, ptr in self.storage)

    def busy(self):
        return self.pending is not None and self.pending() is not None


class _GraphFunction(torch.autograd.Function):
    """A recorded call of a captured entry: the forward graph's replay,
    with the backward graph's replay as its backward (first-order only:
    ``autograd.grad(..., create_graph=True)`` refuses it)."""

    _first_order_only = True
    _mx_name = "hybridized block (replayed CUDA graph)"

    @staticmethod
    def forward(ctx, graph, entry, tensors, *diff):
        outs = graph._replay_forward(entry, tensors)
        ctx.graph, ctx.entry = graph, entry
        ctx.mark_non_differentiable(*[
            outs[i] for i in range(len(outs)) if i not in entry.diff_out])
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gouts):
        grads = ctx.graph._replay_backward(ctx.entry, gouts)
        return (None, None, None, *grads)


class _CachedGraph:
    """The hybridized calls of one block."""

    def __init__(self, block):
        self.block = block
        self.params = list(block.collect_params().values())
        self._ready = False
        #: key -> _Entry, least recently used first
        self._signatures = collections.OrderedDict()
        #: entries made (a capture each on a CUDA block)
        self.captures = 0
        self._lock = threading.RLock()

    # -- the key -------------------------------------------------------------
    def _signature(self, args, kwargs):
        leaves, spec = pytree.tree_flatten((args, kwargs))
        tensors, statics = [], []
        for leaf in leaves:
            if isinstance(leaf, onp.ndarray):
                # a raw array is an input, never a constant baked in
                leaf = torch.from_numpy(leaf)
            if isinstance(leaf, torch.Tensor):
                tensors.append(leaf)
                statics.append(_ARR)
            else:
                statics.append(leaf)
        recording = (_autograd.is_recording() and torch.is_grad_enabled()
                     and (any(t.requires_grad for t in tensors)
                          or any(p.grad_req != "null" for p in self.params)))
        training = _autograd.is_training()
        key = (str(spec), tuple(_static_repr(s) if s is not _ARR else "A"
                                for s in statics),
               tuple((tuple(t.shape), t.dtype, t.device, t.requires_grad)
                     for t in tensors),
               recording, training,
               (_amp.is_active(), str(_amp.target_dtype())),
               tuple(_config.get(k) for k in _ROUTE_KNOBS))
        return key, spec, statics, tensors, recording, training

    def _is_ready(self):
        """Whether every parameter has its shape and values (else the call
        runs eagerly: the first call of a deferred parameter)."""
        if not self._ready:
            self._ready = all(p.initialized and p._shape_known()
                              and p._deferred is None for p in self.params)
        return self._ready

    def _on_cuda(self, tensors):
        """Whether the block (its first parameter, else its first input)
        is on the card."""
        first = self.params[0]._var if self.params else \
            (tensors[0] if tensors else None)
        return first is not None and first.device.type == "cuda"

    # -- a call ---------------------------------------------------------------
    def __call__(self, args, kwargs):
        if _profiler._state["running"] and \
                _profiler._config["profile_symbolic"]:
            # one span per hybridized call (the reference profiles
            # CachedOp as a single engine op)
            with _profiler.span(f"CachedOp:{type(self.block).__name__}",
                                "symbolic"):
                return self._call(args, kwargs)
        return self._call(args, kwargs)

    def _call(self, args, kwargs):
        if not self._is_ready():
            return self._eager(args, kwargs)
        key, spec, statics, tensors, recording, training = \
            self._signature(args, kwargs)
        name = type(self.block).__name__
        with self._lock:
            entry = self._signatures.get(key)
            if entry is not None and entry.stale():
                del self._signatures[key]
                entry = None
            if _telemetry._active:
                _telemetry.inc("cached_graph.cache_miss_total" if entry is None
                               else "cached_graph.cache_hit_total",
                               block=name)
            if entry is None:
                while len(self._signatures) >= max(
                        1, _config.get("cached_graph.max_signatures")):
                    self._signatures.popitem(last=False)
                entry = _Entry(self.params)
                self.captures += 1
                t0 = time.perf_counter()
                if not self._on_cuda(tensors):
                    with _hooks.tracing(), self._counted(entry, tensors) \
                            as cost:
                        out = self._eager(args, kwargs)
                        cost["outputs"] = out
                    entry.cost = _without_outputs(cost)
                    entry.out_spec = pytree.tree_structure(out)
                    self._signatures[key] = entry
                    self._note_entry(entry, name, tensors,
                                     time.perf_counter() - t0)
                    return out
                self._refuse_collectives(training)
                self._capture(entry, spec, statics, tensors, recording,
                              training)
                self._signatures[key] = entry
                self._note_entry(entry, name, tensors,
                                 time.perf_counter() - t0)
            self._signatures.move_to_end(key)
            if entry.fwd is None:
                with _hooks.silent():
                    return self._eager(args, kwargs)
            if not entry.diff_out:
                outs = self._replay_forward(entry, tensors)
                return self._unflatten(entry, outs)
            if entry.busy():
                raise MXNetError(
                    f"hybridized {type(self.block).__name__}: this "
                    "signature's recorded call has not run its backward yet; "
                    "its captured graph holds that call's saved activations, "
                    "so it cannot record again before it (call "
                    "autograd.backward first, drop the outputs, or "
                    "hybridize(False))")
            trainable = [p._var for p in entry.trainable]
            diff = [tensors[i] for i in entry.diff_in]
            outs = _GraphFunction.apply(self, entry, tensors, *diff,
                                        *trainable)
            entry.pending = weakref.ref(outs[entry.diff_out[0]].grad_fn) \
                if entry.diff_out else None
            return self._unflatten(entry, outs)

    def _refuse_collectives(self, training):
        """Raise before a capture whose forward would run a collective:
        BatchNorm's global-batch statistics sum over the ranks (a layer
        whose parameters a Trainer over a dist store updates, a
        SyncBatchNorm, a dp step), and a gloo collective cannot be
        captured in a CUDA graph. Decided from the configuration, before
        anything is captured."""
        if not training:
            return
        from ..parallel.collectives import batch_stats_group
        from .nn.basic_layers import BatchNorm
        scoped = batch_stats_group().size > 1
        if any(isinstance(m, BatchNorm) and (scoped or m.syncs_batch_stats())
               for m in self.block.modules()):
            raise MXNetError(
                f"hybridized {type(self.block).__name__} trains BatchNorm "
                "on the global batch's statistics (summed over the ranks "
                "in the forward), and a collective cannot be captured in "
                "a CUDA graph; train it with hybridize(False) under data "
                "parallelism")

    def _eager(self, args, kwargs):
        with plain_scope():
            return self.block._forward_tensors(args, kwargs)

    def _counted(self, entry, tensors):
        """The cost count of the run that makes ``entry`` (while
        mx.insight is on): its inputs are the call's tensors and the
        block's parameters."""
        if not _insight._active:
            return contextlib.nullcontext({})
        return _insight.count([*tensors, *(p._var for p in self.params)])

    def _note_entry(self, entry, name, tensors, seconds):
        """Account a new entry: ``note_compile`` (the recompile detector)
        and the entry's cost in mx.insight's registry."""
        if _telemetry._active:
            _telemetry.note_compile(self.block, name, seconds,
                                    signatures=len(self._signatures))
        if _insight._active:
            _insight.capture_jit(f"cached_graph.{name}", entry, tensors,
                                 kind="cached_graph")

    def _unflatten(self, entry, outs):
        leaves = list(entry.out_leaves)
        it = iter(outs)
        for i, leaf in enumerate(leaves):
            if leaf is _ARR:
                leaves[i] = next(it)
        return pytree.tree_unflatten(leaves, entry.out_spec)

    # -- capture --------------------------------------------------------------
    def _run(self, spec, statics, tensors, recording, training, aliases):
        leaves = list(statics)
        it = iter(tensors)
        for i, leaf in enumerate(leaves):
            if leaf is _ARR:
                leaves[i] = next(it)
        args, kwargs = pytree.tree_unflatten(leaves, spec)
        with plain_scope(), _substituted(self.block, aliases), \
                _autograd._RecordingStateScope(recording, training):
            return self.block._forward_tensors(args, kwargs)

    def _capture(self, entry, spec, statics, tensors, recording, training):
        """Warm up and capture ``entry``'s graphs (module docstring)."""
        t0 = time.perf_counter()
        device = (self.params[0]._var if self.params else tensors[0]).device
        trainable = [p for p in self.params if p.grad_req != "null"] \
            if recording else []
        entry.trainable = trainable
        entry.diff_in = [i for i, t in enumerate(tensors)
                         if recording and t.requires_grad]
        static_in = [t.detach().clone() for t in tensors]
        for i in entry.diff_in:
            static_in[i].requires_grad_(True)
        entry.static_in = static_in
        aux = [p._var for p in self.params if p.grad_req == "null"]
        # the capture differentiates with respect to aliases of the
        # trainable parameters (their storage, fresh leaves), which the
        # forward reads in their place: their gradient accumulators are
        # made on the capture stream, whatever an eager graph still alive
        # over the parameters holds (a leaf's own accumulator, made on the
        # default stream, made the backward's capture join that stream)
        aliases = {p._var: _alias(p) for p in trainable}
        wrt = [aliases[p._var] for p in trainable] + [static_in[i]
                                                     for i in entry.diff_in]

        def forward_outputs():
            out = self._run(spec, statics, static_in, recording, training,
                            aliases)
            leaves, out_spec = pytree.tree_flatten(out)
            return leaves, out_spec

        def grads_of(outs, cots):
            return torch.autograd.grad(outs, wrt, cots, retain_graph=True,
                                       allow_unused=True)

        gens = {}
        with _capture_lock, _gc_paused():
            stream = _capture_stream(device)
            saved_aux = [v.detach().clone() for v in aux]
            stream.wait_stream(torch.cuda.current_stream(device))
            try:
                with torch.cuda.stream(stream), \
                        _random.track_generators() as gens, \
                        _hooks.tracing(), \
                        self._counted(entry, tensors) as cost:
                    leaves, _ = forward_outputs()
                    cost["outputs"] = leaves
                    outs = [o for o in leaves if isinstance(o, torch.Tensor)
                            and o.requires_grad]
                    if recording and outs and wrt:
                        grads_of(outs, [torch.ones_like(o) for o in outs])
                    del leaves, outs
                entry.cost = _without_outputs(cost)
                torch.cuda.current_stream(device).wait_stream(stream)
            finally:
                with torch.no_grad():
                    for v, s in zip(aux, saved_aux):
                        v.copy_(s)
                for gen, state in gens.items():
                    gen.set_state(state)
            del saved_aux
            pool = torch.cuda.graph_pool_handle()
            fwd = torch.cuda.CUDAGraph()
            for gen in gens:
                if not hasattr(fwd, "register_generator_state"):
                    raise MXNetError(
                        "this torch's CUDAGraph has no "
                        "register_generator_state: a forward that draws "
                        "dropout masks cannot be captured")
                fwd.register_generator_state(gen)
            with torch.cuda.graph(fwd, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"), \
                    _hooks.silent():
                leaves, out_spec = forward_outputs()
            entry.out_spec = out_spec
            entry.out_leaves = [_ARR if isinstance(o, torch.Tensor) else o
                                for o in leaves]
            entry.static_out = [o for o in leaves
                                if isinstance(o, torch.Tensor)]
            entry.diff_out = [i for i, o in enumerate(entry.static_out)
                              if recording and o.requires_grad]
            entry.fwd = fwd
            # recorded after every replay: the next one, on whatever
            # stream, waits for it before it writes the static buffers
            entry.done = torch.cuda.Event()
            if entry.diff_out and wrt:
                entry.static_cot = [torch.empty_like(entry.static_out[i])
                                    for i in entry.diff_out]
                bwd = torch.cuda.CUDAGraph()
                with torch.cuda.graph(bwd, pool=pool, stream=stream,
                                      capture_error_mode="thread_local"), \
                        _hooks.silent():
                    grads = grads_of([entry.static_out[i]
                                      for i in entry.diff_out],
                                     entry.static_cot)
                entry.bwd = bwd
                n = len(trainable)
                # the Function's order: inputs that require grad, then the
                # trainable parameters
                entry.static_grads = list(grads[n:]) + list(grads[:n])
            else:
                entry.diff_out = []
            # the capture's autograd graph goes: its saved tensors stay in
            # this entry's pool (no other capture allocates from it), and
            # the parameters' gradient accumulators it holds would keep the
            # capture stream as their stream
            entry.static_out = [o.detach() for o in entry.static_out]
            del leaves
        torch.cuda.current_stream(device).wait_stream(stream)
        entry.capture_s = time.perf_counter() - t0

    # -- replay ---------------------------------------------------------------
    def _replay_forward(self, entry, tensors):
        stream = torch.cuda.current_stream()
        stream.wait_event(entry.done)
        with torch.no_grad():
            for buf, t in zip(entry.static_in, tensors):
                if buf.data_ptr() != t.data_ptr():
                    buf.copy_(t)
            entry.fwd.replay()
            outs = tuple(o.clone() for o in entry.static_out)
        entry.done.record(stream)
        return outs

    def _replay_backward(self, entry, gouts):
        with self._lock, torch.no_grad():
            stream = torch.cuda.current_stream()
            stream.wait_event(entry.done)
            for buf, i in zip(entry.static_cot, entry.diff_out):
                g = gouts[i]
                if g is None:
                    buf.zero_()
                else:
                    buf.copy_(g)
            entry.bwd.replay()
            entry.done.record(stream)
            entry.pending = None
            # fresh tensors: the next replay overwrites the static ones, and
            # a caller of autograd.grad keeps what it was given
            return [None if g is None else g.clone()
                    for g in entry.static_grads]
