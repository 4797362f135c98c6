"""``HybridBlock`` as an ``nn.Module``.

Counterpart of ``mxnet_tpu/gluon/block.py``. Each parameter is a
:class:`~.parameter.Parameter` whose tensor (an ``nn.Parameter``) is
registered on its block on the block's device at construction; a layer
told no input width gets a deferred parameter (a 0 in its shape) whose
shape its first forward finishes (``Parameter._finish_deferred_init``), as
in the JAX package.
``collect_params()`` returns ``{structural name: Parameter}`` under the
JAX package's names (attribute paths, e.g.
``backbone.decoder.layer0.attention.query_proj.weight``), so weights carry
across by name. ``copy.deepcopy(block)`` gives a block with the same
names and values on new storage (``parameter._Var``).

A block takes ``mx.np`` arrays as well as tensors: ``__call__`` unwraps
``ndarray`` arguments to their tensors, and returns ``ndarray``s when any
argument was one, else the forward's outputs as tensors (a forward written
in ``mx.np`` returns ``ndarray``s; they are unwrapped). The forward,
``_CachedGraph`` and the kernels below see tensors only.

A block called while ``autograd`` is not recording runs under
``torch.no_grad()`` (``__call__``): as in the reference, only computation
under ``autograd.record()`` can be differentiated. A method that is not
``forward`` and reads a parameter itself, rather than through a sub-block's
call (the tied LM head's KV-cache entry points), takes the same gate through
:func:`recording_gate`.

``hybridize()`` makes a block's calls go through a ``_CachedGraph``
(``gluon/cached_graph.py``): on the card, CUDA graphs of the forward and,
under ``record()``, of its backward, captured per input signature; on the
CPU the same cache and key with the forward run eagerly. ``backend=``
(subgraph partitioning) is not ported and raises. ``remat=`` (reference:
``resolve_remat_policy``) recomputes the block's activations in the
backward, layer by layer (``remat_targets``: each ``layer<N>`` of the
block's layer family, else the whole block): ``True`` is
``torch.utils.checkpoint`` (non-reentrant), ``'dots'`` /
``'dots_with_no_batch_dims'`` selective checkpointing that keeps the
matmul outputs (with / without batched matmuls), a callable the policy
itself; the port's dropout generators are put back for the recompute,
so the recomputed masks are the forward's. ``ShardedTrainStep``
inherits the flag.

``save_parameters`` / ``load_parameters`` read and write the reference's
files (npz, ``.safetensors``, a legacy Apache MXNet ``.params``) through
``serialization.py``, so checkpoints cross between the two packages by
structural name; bf16 goes through numpy widened to fp32 and is rounded
back exactly. ``share_parameters`` and ``reset_ctx`` are the reference's.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import io
import os
import re

import numpy as onp
import torch
from torch import nn

from .. import autograd as _autograd
from .. import random as _random
from .. import serialization
from ..base import MXNetError
from ..context import resolve_device
from ..numpy.multiarray import _unwrap_out, _wrap_out, ndarray
from .cached_graph import _CachedGraph, in_plain_scope
from .parameter import Constant

__all__ = ["HybridBlock", "recording_gate", "resolve_remat_policy",
           "remat_call", "remat_scope"]

class _RematOff:
    """The "rematerialization off" sentinel's type: one instance, kept
    through copies and pickles (a block's deep copy keeps it)."""

    __slots__ = ()

    def __copy__(self):
        return self

    def __deepcopy__(self, memo):
        return self

    def __reduce__(self):
        return "_REMAT_OFF"

    def __repr__(self):
        return "_REMAT_OFF"


#: sentinel for "rematerialization off" (a policy of None means full
#: rematerialization, as a jax.checkpoint policy of None does)
_REMAT_OFF = _RematOff()

_MM = ("mm", "addmm", "_scaled_mm", "_int_mm")
_BMM = ("bmm", "baddbmm")


def _saves(names):
    """A selective-checkpoint policy saving the outputs of aten ``names``
    and recomputing everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    ops = {getattr(torch.ops.aten, n).default for n in names
           if hasattr(torch.ops.aten, n)}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


_REMAT_POLICIES = {
    "dots": _MM + _BMM,
    "dots_saveable": _MM + _BMM,
    "dots_with_no_batch_dims": _MM,
    "dots_with_no_batch_dims_saveable": _MM,
    "nothing": None,
    "everything": "everything",
}


def resolve_remat_policy(remat):
    """Map a ``hybridize(remat=...)`` value onto a checkpoint policy
    (reference: block.py ``resolve_remat_policy``). ``False`` / ``None``:
    off (:data:`_REMAT_OFF`); ``True`` / ``'nothing'``: None, full
    rematerialization (only the inputs are kept); ``'dots'``: keep the
    outputs of the matmuls (mm, addmm, bmm, baddbmm), recompute the rest;
    ``'dots_with_no_batch_dims'``: keep only the unbatched ones;
    ``'everything'``: keep every output; a callable ``(ctx, op, *args,
    **kwargs) -> CheckpointPolicy or bool`` (True: save) is the policy."""
    if remat is None or remat is False:
        return _REMAT_OFF
    if remat is True:
        return None
    if callable(remat):
        def policy(ctx, op, *args, **kwargs):
            from torch.utils.checkpoint import CheckpointPolicy
            out = remat(ctx, op, *args, **kwargs)
            if isinstance(out, bool):
                return (CheckpointPolicy.MUST_SAVE if out
                        else CheckpointPolicy.PREFER_RECOMPUTE)
            return out
        return policy
    if not isinstance(remat, str) or remat not in _REMAT_POLICIES:
        raise MXNetError(
            f"unknown remat policy {remat!r}: expected True/False, one of "
            f"{sorted(_REMAT_POLICIES)}, or a policy callable")
    names = _REMAT_POLICIES[remat]
    if names is None:
        return None
    if names == "everything":
        from torch.utils.checkpoint import CheckpointPolicy
        return lambda ctx, op, *a, **k: CheckpointPolicy.MUST_SAVE
    return _saves(names)


def remat_call(policy, fn, *args):
    """``fn(*args)`` whose activations are recomputed in the backward under
    ``policy`` (from :func:`resolve_remat_policy`; not :data:`_REMAT_OFF`).
    The generators the forward's samplers drew from (dropout) are set back
    to their states before the forward for the recompute and restored
    after it, so the recompute draws the same masks."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    drawn = {}
    first = [True]
    # the recompute runs in the backward, outside record(): it re-enters
    # the forward's recording and training state
    mode = (_autograd.is_recording(), _autograd.is_training())

    def run(*a):
        if first[0]:
            first[0] = False
            outer = getattr(_random._local, "track", None)
            with _random.track_generators() as track:
                out = fn(*a)
            drawn.update(track)
            if outer is not None:
                for g, st in track.items():
                    outer.setdefault(g, st)
            return out
        now = {g: g.get_state() for g in drawn}
        for g, st in drawn.items():
            g.set_state(st)
        try:
            with _autograd._RecordingStateScope(*mode):
                return fn(*a)
        finally:
            for g, st in now.items():
                g.set_state(st)

    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    # torch's own RNG state cannot be read while a CUDA graph captures;
    # the port's samplers draw from the generators put back above
    capturing = torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=not capturing, **kw)


_LAYER = re.compile(r"(^|\.)layer\d+$")


def remat_targets(block):
    """The blocks whose forwards remat checkpoints one at a time: the
    outermost submodules named ``layer<N>`` (the repeated layer family the
    reference stacks for pipelining), else ``block`` itself. Per layer, a
    layer's activations are recomputed just before its own backward, so
    only one layer's live at a time."""
    out = []
    for name, m in block.named_modules():
        if not (_LAYER.search(name) and isinstance(m, HybridBlock)):
            continue
        if any(name.startswith(o + ".") for o, _ in out):
            continue
        out.append((name, m))
    return [m for _, m in out] or [block]


@contextlib.contextmanager
def remat_scope(block, policy):
    """Within: every :func:`remat_targets` block of ``block`` runs its
    forward through :func:`remat_call` under ``policy`` while recording
    (what ``hybridize(remat=)`` and ``ShardedTrainStep(remat=)`` do)."""
    targets = remat_targets(block)
    prev = [(t, t._remat_policy) for t in targets]
    scoped = block._remat_scoped
    for t in targets:
        t._remat_policy = policy
    block._remat_scoped = True
    try:
        yield
    finally:
        for t, p in prev:
            t._remat_policy = p
        block._remat_scoped = scoped


def recording_gate(fn):
    """Run ``fn`` under ``torch.no_grad()`` unless ``autograd`` is
    recording: what a block computes outside ``record()`` builds no
    autograd graph."""
    @functools.wraps(fn)
    def gated(*args, **kwargs):
        if not torch.is_grad_enabled() or _autograd.is_recording():
            return fn(*args, **kwargs)
        with torch.no_grad():
            return fn(*args, **kwargs)
    return gated


class HybridBlock(nn.Module):
    """Base block: a ``torch.nn.Module`` with the Gluon parameter surface.

    Dropout follows ``autograd.is_training()`` (set by ``record()`` and
    ``train_mode()``), not ``nn.Module.training``."""

    def __init__(self):
        super().__init__()
        self.training = False
        self._active = False
        #: the _CachedGraph of this block's calls, once hybridized
        self._cached_graph = None
        #: every parameter of this block itself was seen initialized
        self._init_checked = False
        #: hybridize()'s flags (the reference's ``_flags``): remat
        self._flags = {}
        #: the checkpoint policy of this block's forward inside a
        #: remat_scope (_REMAT_OFF: a plain forward; None is full remat)
        self._remat_policy = _REMAT_OFF
        self._remat_scoped = False

    def _check_initialized(self):
        """Raise where a parameter of this block was never initialized
        and has no deferred initialization pending, as the reference's
        ``Parameter.data()`` does (fault 19: the port computed with
        uninitialized memory); checked until every one is initialized."""
        done = True
        for name, var in self._parameters.items():
            p = getattr(var, "_mx_param", None)
            if var is None or p is None or p.initialized:
                continue
            if p._deferred is None:
                raise MXNetError(f"parameter {name} not initialized; call "
                                 ".initialize() before forward")
            done = False
        self._init_checked = done

    def __call__(self, *args, **kwargs):
        if not self._init_checked:
            self._check_initialized()
        arrays = False
        for a in args:
            if type(a) is ndarray:
                arrays = True
                break
        if arrays or (kwargs and any(type(v) is ndarray
                                     for v in kwargs.values())):
            args = tuple(a._data if type(a) is ndarray else a for a in args)
            kwargs = {k: v._data if type(v) is ndarray else v
                      for k, v in kwargs.items()}
            arrays = True
        # recording_gate, written out: this runs for every nested block
        if torch.is_grad_enabled() and not _autograd.is_recording():
            with torch.no_grad():
                out = self._call(args, kwargs)
        else:
            out = self._call(args, kwargs)
        return _wrap_out(out) if arrays else out

    def _call(self, args, kwargs):
        if not self._active or in_plain_scope():
            return self._forward_tensors(args, kwargs)
        if self._cached_graph is None:
            self._cached_graph = _CachedGraph(self)
        return self._cached_graph(args, kwargs)

    def _forward_tensors(self, args, kwargs):
        """The plain forward, its ``ndarray`` outputs as tensors; while
        recording under ``hybridize(remat=...)``, inside a
        :func:`remat_scope` (each layer of the family, or the block,
        through :func:`remat_call`)."""
        if torch.is_grad_enabled() and _autograd.is_recording():
            if self._remat_policy is not _REMAT_OFF:
                out = remat_call(self._remat_policy,
                                 lambda *a: nn.Module.__call__(self, *a,
                                                               **kwargs),
                                 *args)
                return out if type(out) is torch.Tensor \
                    else _unwrap_out(out)
            remat = self._flags.get("remat") if self._active else None
            if remat and not self._remat_scoped:
                with remat_scope(self, resolve_remat_policy(remat)):
                    return self._forward_tensors(args, kwargs)
        out = super().__call__(*args, **kwargs)
        return out if type(out) is torch.Tensor else _unwrap_out(out)

    def __deepcopy__(self, memo):
        """A copy without the cached graphs: they hold this block's
        storage, locks and CUDA graphs; the copy captures its own."""
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            new.__dict__[k] = None if k == "_cached_graph" \
                else copy.deepcopy(v, memo)
        return new

    # -- hybridize ------------------------------------------------------------
    def hybridize(self, active=True, backend=None, backend_opts=None,
                  clear=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Cache this block's calls, and its children's (reference:
        block.py ``hybridize``): CUDA graphs on the card
        (``gluon/cached_graph.py``). ``static_alloc`` / ``static_shape``
        are what a captured graph does anyway (static buffers, one graph a
        shape) and are accepted as in the reference. ``clear`` drops the
        graphs captured so far. Children called inside a hybridized call
        run their plain forward (one graph per outermost call).
        ``remat=`` (True, 'dots', 'dots_with_no_batch_dims', a policy
        callable) recomputes the activations in the backward
        (:func:`remat_call`); bad values raise here."""
        resolve_remat_policy(kwargs.get("remat"))  # fail fast
        if backend is not None:
            raise MXNetError(
                f"hybridize(backend={backend!r}): subgraph backends are not "
                "ported yet (ROADMAP.md Queue 1, item 2: backend= / "
                "optimize_for partitioning)")
        self._active = bool(active)
        self._flags = {"remat": kwargs.get("remat")} \
            if kwargs.get("remat") else {}
        if clear:
            self._cached_graph = None
        # remat wraps this block's forward once; children inside it run
        # their plain forwards
        kwargs.pop("remat", None)
        for child in _hybrid_children(self):
            child.hybridize(active, backend=backend,
                            backend_opts=backend_opts, clear=clear,
                            static_alloc=static_alloc,
                            static_shape=static_shape, **kwargs)

    def optimize_for(self, x, *args, backend=None, clear=True, **kwargs):
        """Hybridize for ``backend`` and run once (reference: block.py
        ``optimize_for``); no subgraph backend is ported, so ``backend``
        must be None."""
        self.hybridize(True, backend=backend, clear=clear, **kwargs)
        return self(x, *args)

    def _clear_cached_graphs(self):
        for block in self.modules():
            if isinstance(block, HybridBlock):
                block._cached_graph = None

    def collect_params(self, select=None):
        """dict structural-name -> :class:`Parameter` (tied parameters
        once); ``select`` keeps the names it matches from their start
        (``re.match``, e.g. ``".*weight"``), as in the reference."""
        pattern = None if select is None else re.compile(select)
        out = {}
        for name, var in self.named_parameters():
            param = var._mx_param
            param.name = name
            if pattern is None or pattern.match(name):
                out[name] = param
        return out

    def setattr(self, name, value):
        """Set attribute ``name`` (e.g. ``grad_req``, ``lr_mult``) on every
        parameter."""
        for p in self.collect_params().values():
            setattr(p, name, value)

    def cast(self, dtype):
        """Cast every parameter to ``dtype`` (a dtype or its name;
        reference: block.py ``cast``, the bf16 training path with
        ``multi_precision``); returns the block."""
        for p in self.collect_params().values():
            p.cast(dtype)
        return self

    def reset_ctx(self, ctx):
        """Move every parameter to device ``ctx`` (reference: block.py
        ``reset_ctx``)."""
        for p in self.collect_params().values():
            p.reset_ctx(ctx)

    reset_device = reset_ctx

    def share_parameters(self, shared):
        """Use the parameters of ``shared`` ({structural name: Parameter},
        e.g. another block's ``collect_params()``) wherever this block has
        a parameter of that name (reference: block.py
        ``share_parameters``); returns the block."""
        mine = self.collect_params()
        for name, p in shared.items():
            if name in mine:
                path, _, attr = name.rpartition(".")
                owner = self.get_submodule(path) if path else self
                setattr(owner, attr, p.data())
                owner._init_checked = False
        self._clear_cached_graphs()
        return self

    # -- save / load ----------------------------------------------------------
    def save_parameters(self, filename, deduplicate=False):
        """Write every parameter that holds values, by structural name
        (reference: block.py ``save_parameters``): npz, or safetensors
        where ``filename`` ends in ``.safetensors``; crash-atomic (a
        same-directory temporary file, fsync, ``os.replace``). Tied
        parameters are written once either way (``deduplicate`` is
        accepted as in the reference). bf16 is written widened to fp32."""
        from ..functional import param_arrays  # functional imports gluon
        arrays = param_arrays(self)
        if filename.endswith(".safetensors"):
            serialization.save_safetensors(filename, arrays)
            return
        buf = io.BytesIO()
        onp.savez(buf, **arrays)
        serialization.atomic_write_bytes(filename, buf.getvalue())

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current", device=None):
        """Load what :meth:`save_parameters` (either package's) wrote, by
        structural name (reference: block.py ``load_parameters``): npz
        (``filename`` or ``filename + ".npz"``), ``.safetensors``, or a
        legacy Apache MXNet ``.params`` file (``arg:`` / ``aux:`` prefixes
        stripped; a name under both, or unnamed arrays, raise). A
        ``.sha256`` sidecar is verified first. A parameter the file lacks
        raises unless ``allow_missing``, a name the block lacks unless
        ``ignore_extra``; both are checked before any value is copied.
        Values are copied in place into each parameter's own dtype and
        device (a deferred parameter takes the array's shape), as the
        reference casts to the current dtype (``cast_dtype`` /
        ``dtype_source`` are accepted as it accepts them); ``ctx`` /
        ``device`` then move the block."""
        real = filename if os.path.exists(filename) else filename + ".npz"
        if os.path.exists(real):
            serialization.verify_checksum(real)
        if filename.endswith(".safetensors"):
            loaded = serialization.load_safetensors(filename)
        elif os.path.exists(filename) \
                and serialization.is_legacy_params(filename):
            loaded = _strip_legacy(filename,
                                   serialization.load_legacy_params(filename))
        else:
            with onp.load(real, allow_pickle=False) as data:
                loaded = {k: data[k] for k in data.files}
        params = self.collect_params()
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise MXNetError(f"parameter {name} missing in "
                                     f"{filename}")
        extra = set(loaded) - set(params)
        if extra and not ignore_extra:
            raise MXNetError(f"file {filename} has extra parameters "
                             f"{sorted(extra)}")
        for name, p in params.items():
            if name in loaded:
                p.set_data(torch.from_numpy(
                    onp.ascontiguousarray(loaded[name])))
        if ctx is not None or device is not None:
            self.reset_ctx(device if device is not None else ctx)

    def save(self, prefix):
        """``save_parameters(prefix + "-model.params")`` (reference:
        block.py ``save``)."""
        self.save_parameters(prefix + "-model.params")

    def load(self, prefix):
        """``load_parameters(prefix + "-model.params")``."""
        self.load_parameters(prefix + "-model.params")

    def zero_grad(self):
        """Zero every parameter's gradient buffer in place (the reference's
        ``Block.zero_grad``)."""
        for p in self.collect_params().values():
            p.zero_grad()

    @property
    def device(self):
        for p in self.parameters():
            return p.device
        raise MXNetError(f"{type(self).__name__} holds no parameters")

    @property
    def initialized(self):
        return all(p.initialized for p in self.collect_params().values())

    @torch.no_grad()
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, device=None, seed=None):
        """Fill every parameter on its own device, in ``collect_params``
        order, from the default generator of that device
        (``random.default_generator``, which ``random.seed`` reseeds), as
        the reference draws from its global key stream; ``seed`` draws
        instead from one fresh ``torch.Generator`` per device seeded with
        it. ``ctx`` / ``device`` (a ``Context``, ``torch.device`` or name)
        first moves every parameter there (reference: block.py
        ``initialize(init, ctx)``). A parameter's own initializer (a
        layer's ``weight_initializer=`` / ``bias_initializer=``) comes
        before ``init``, which defaults to ``Uniform(0.07)``; either may be
        a name (``initializer.create``). The names get the JAX package's
        rule (``initializer.Initializer``). A parameter of unknown shape
        records the initializer and the generator and draws at the first
        forward. A :class:`~.parameter.Constant` keeps its value (the
        reference's re-initialization copies it back)."""
        dev = None if ctx is None and device is None else \
            resolve_device(device if device is not None else ctx)
        gens = {}
        for p in self.collect_params().values():
            if dev is not None and p.device != dev:
                p.reset_ctx(dev)
            if isinstance(p, Constant):
                continue
            gen = gens.get(p.device)
            if gen is None:
                gen = gens[p.device] = (
                    _random.default_generator(p.device) if seed is None
                    else _random.generator(seed, p.device))
            p.initialize(default_init=init, force_reinit=force_reinit,
                         generator=gen)
        return self


def _hybrid_children(module):
    """The nearest ``HybridBlock`` descendants of ``module``."""
    for child in module.children():
        if isinstance(child, HybridBlock):
            yield child
        else:
            yield from _hybrid_children(child)


def _strip_legacy(filename, loaded):
    """A legacy ``.params`` file's arrays by parameter name: Apache MXNet
    1.x's ``arg:`` / ``aux:`` prefixes stripped (reference: block.py
    ``load_parameters``)."""
    if isinstance(loaded, list):
        raise MXNetError(f"{filename} holds unnamed arrays; parameters need "
                         "names to load into a Block (save with a dict)")
    stripped = {}
    for k, v in loaded.items():
        base = k.split(":", 1)[1] if k.startswith(("arg:", "aux:")) else k
        if base in stripped:
            raise MXNetError(f"{filename}: parameter {base!r} appears as "
                             "both arg: and aux:; cannot merge into one "
                             "namespace")
        stripped[base] = v
    return stripped
