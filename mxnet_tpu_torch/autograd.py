"""Autograd: recording scopes, train/predict mode and backward.

Counterpart of ``mxnet_tpu/autograd.py`` (``record``/``pause``/
``train_mode``/``predict_mode``, ``is_recording``/``is_training``,
``backward``, ``grad``), over ``torch.autograd`` instead of a tape.

- The two flags are thread-local, as in the reference. ``record()``
  turns on recording and (by default) training; ``pause()`` turns
  recording off. Recording maps onto torch's grad mode: ``record`` enters
  ``torch.enable_grad()``, ``pause`` ``torch.no_grad()``, and a Gluon block
  called while nothing records runs under ``torch.no_grad()``
  (``gluon/block.py``), so, as in the reference, only what runs under
  ``record()`` can be differentiated.
- :func:`backward` writes each reached leaf's gradient by its parameter's
  ``grad_req``: ``"write"`` (the default, and the rule for a tensor that
  is no Gluon parameter) overwrites ``.grad``, ``"add"`` accumulates into
  it; ``"null"`` parameters do not require grad and are never reached. A
  non-scalar head is seeded with ones, as the reference's is
  (``autograd.py:238``), so a per-sample loss of shape ``(batch,)`` goes
  through :func:`backward` (a torch ``loss.backward()`` on it raises).
- Heads, head gradients and variables may be ``mx.np`` ``ndarray``s;
  :func:`grad` then returns ``ndarray``s. :func:`mark_variables` (what
  ``ndarray.attach_grad`` is built on) makes an array a leaf with a
  gradient buffer and its own ``grad_req``; its "add" accumulates out of
  place, so a gradient read earlier never sees a later backward.
- ``grad(create_graph=True)`` records the gradient computation itself
  (torch's own graph), so it can be differentiated again, to any order
  (reference: ``autograd.py`` ``_apply_vjp_create_graph``). A function
  with only a first-order backward cannot: a custom :class:`Function`,
  a kernel's ``torch.autograd.Function`` (flash attention, ln_residual,
  the conv3x3+BN+ReLU backward) and a hybridized block's replayed CUDA
  graph. ``grad(create_graph=True)`` over a graph holding one raises
  ``MXNetError`` naming it, as the reference's raises for a node without
  a re-differentiable function; it never returns a second derivative
  that is silently zero.
- A row-sparse gradient (``npx.embedding(sparse_grad=True)``): each
  call's backward puts its ids and cotangent rows in the weight's sink,
  and :func:`backward` writes the concatenation of one backward's rows as
  a torch COO gradient, which a parameter's ``grad()`` (and an attached
  array's ``grad``) reads as a ``RowSparseNDArray`` of as many slots as
  rows (reference: ``autograd.py:445-460``: its sparse cotangents merge
  through ``sparse.add``, concatenating); :func:`grad` returns one too.
  Under "add" two sparse gradients stay sparse, their entries
  concatenated, and a dense one beside a sparse one densifies (reference:
  multiarray.py ``_write_grad``).
- :class:`Function` is the reference's custom function (``forward`` and
  ``backward`` written by the user on arrays); ``get_symbol`` raises as
  the reference's does.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "backward", "grad", "mark_variables", "Function",
           "get_symbol"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


class _RecordingStateScope:
    """Sets (recording, training) on entry and restores both, and torch's
    grad mode, on exit. ``None`` leaves a flag as it is."""

    def __init__(self, is_record, train_mode):
        self._rec, self._train = is_record, train_mode
        self._prev = None
        self._grad_mode = None

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        if self._rec is not None:
            st.recording = bool(self._rec)
            self._grad_mode = torch.set_grad_enabled(bool(self._rec))
            self._grad_mode.__enter__()
        if self._train is not None:
            st.training = bool(self._train)
        return self

    def __exit__(self, *exc):
        st = _st()
        st.recording, st.training = self._prev
        if self._grad_mode is not None:
            self._grad_mode.__exit__(*exc)
            self._grad_mode = None


def record(train_mode=True):
    """Scope whose computation can be differentiated (reference:
    autograd.py ``record``); ``train_mode`` also turns dropout on."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    """Scope inside ``record()`` that is not recorded."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    """Training behaviour (live dropout) without changing recording."""
    return _RecordingStateScope(None, True)


def predict_mode():
    """Inference behaviour (dropout off) without changing recording."""
    return _RecordingStateScope(None, False)


def _raw(x):
    """The tensor of an ``mx.np`` array (anything else as it is)."""
    return getattr(x, "_data", x) if not isinstance(x, torch.Tensor) else x


def _as_list(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor) or hasattr(x, "_data"):
        return [_raw(x)]
    return [None if v is None else _raw(v) for v in x]


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each array of ``variables`` a recording leaf whose gradient
    goes to the matching array of ``gradients`` by its ``grad_req``
    ("write", "add" or "null") (reference: autograd.py
    ``mark_variables``)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        var._mark_variable(g, req)


def _seeds(heads, head_grads):
    """Head cotangents: ones where none is given."""
    for h in heads:
        if not h.requires_grad:
            raise MXNetError(
                "cannot differentiate a head that is not the output of a "
                "recorded computation (did you forget autograd.record()?)")
    if head_grads is None:
        head_grads = [None] * len(heads)
    if len(head_grads) != len(heads):
        raise MXNetError(f"{len(heads)} heads but {len(head_grads)} head "
                         "gradients")
    return [torch.ones_like(h) if g is None else g.to(h.dtype)
            for h, g in zip(heads, head_grads)]


def _leaves(heads):
    """Every leaf tensor the heads' graph accumulates a gradient into."""
    out, seen = {}, set()
    stack = []
    for h in heads:
        if h.grad_fn is None:
            out[id(h)] = h  # the head is itself a leaf
        else:
            stack.append(h.grad_fn)
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)  # AccumulateGrad
        if var is not None:
            out[id(var)] = var
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return list(out.values())


def _grad_req(leaf):
    param = getattr(leaf, "_mx_param", None)
    if param is not None:
        return param.grad_req
    return getattr(leaf, "_mx_grad_req", "write")


def _row_sparse(leaf):
    param = getattr(leaf, "_mx_param", None)
    return param is not None and param.grad_stype == "row_sparse"


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into every leaf they reach, by ``grad_req``
    (reference: autograd.py ``backward``): "write" leaves get the fresh
    gradient, "add" leaves accumulate. ``train_mode`` is accepted for the
    reference's signature; the mode was fixed when the heads were
    recorded."""
    heads = _as_list(heads)
    seeds = _seeds(heads, _as_list(head_grads))
    added = []
    leaves = _leaves(heads)
    for leaf in leaves:
        leaf._mx_sink = []   # row-sparse gradient rows (npx.embedding)
    for leaf in leaves:
        req = _grad_req(leaf)
        if req == "add" and (hasattr(leaf, "_mx_grad_req")
                             or _row_sparse(leaf)):
            # an attached array's "add", or a row-sparse parameter's: out
            # of place, after the backward (an attached array's untouched
            # zero buffer gives way, as the reference's all-zero one does)
            old = leaf.grad
            added.append((leaf, None if getattr(old, "_mx_zeros", False)
                          else old))
            leaf.grad = None
        elif req == "write":
            leaf.grad = None  # torch then assigns instead of accumulating
    try:
        torch.autograd.backward(heads, seeds, retain_graph=retain_graph)
    finally:
        for leaf in leaves:
            parts, leaf._mx_sink = leaf._mx_sink, None
            if parts:
                _add_rows(leaf, parts)
    for leaf, old in added:
        if old is not None:
            leaf.grad = old if leaf.grad is None else _accum(old, leaf.grad)


def _add_rows(leaf, parts):
    """One backward's row-sparse gradient rows of ``leaf`` as one torch
    COO gradient, every call's rows concatenated in the order the
    backward reached them, added to what autograd wrote (a dense part
    densifies)."""
    coo = torch.sparse_coo_tensor(
        torch.cat([ids for ids, _ in parts]).unsqueeze(0),
        torch.cat([rows for _, rows in parts]), leaf.shape,
        check_invariants=False)
    leaf.grad = coo if leaf.grad is None else _accum(leaf.grad, coo)


def _accum(old, new):
    """An attached array's "add" (reference: autograd.py ``_accum`` and
    multiarray.py ``_write_grad``): two row-sparse (torch COO) gradients
    stay sparse, their entries concatenated; a dense one with a sparse one
    densifies."""
    if old.is_sparse and new.is_sparse:
        return torch.sparse_coo_tensor(
            torch.cat([old._indices(), new._indices()], 1),
            torch.cat([old._values(), new._values()]), old.shape,
            check_invariants=False)
    if old.is_sparse:
        return new + old
    return old + new


def _first_order_nodes(heads):
    """Names of the nodes of the heads' graph whose backward cannot be
    differentiated again (a ``torch.autograd.Function`` marked
    ``_first_order_only``)."""
    names, seen = [], set()
    stack = [h.grad_fn for h in heads if h.grad_fn is not None]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        cls = getattr(fn, "_forward_cls", None)
        if getattr(cls, "_first_order_only", False):
            names.append(getattr(cls, "_mx_name", cls.__name__))
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return sorted(set(names))


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, without
    touching any ``.grad`` (reference: autograd.py ``grad``). A variable
    the heads do not reach gets zeros. ``create_graph=True`` records the
    gradients' own computation (differentiable again; the graph is then
    retained unless ``retain_graph=False``)."""
    single = isinstance(variables, torch.Tensor) or hasattr(variables,
                                                             "_data")
    arrays = hasattr(variables if single else next(iter(variables), None),
                     "_data")
    variables = _as_list(variables)
    heads = _as_list(heads)
    seeds = _seeds(heads, _as_list(head_grads))
    if create_graph:
        blocked = _first_order_nodes(heads)
        if blocked:
            raise MXNetError(
                f"create_graph=True is not supported through {blocked}: "
                "their backward is first-order only (a custom "
                "autograd.Function, a CUDA kernel's backward or a "
                "hybridized block's replayed graph). Use first-order "
                "grad(), or the block unhybridized with plain ops.")
    if retain_graph is None:
        retain_graph = create_graph
    grads = torch.autograd.grad(heads, variables, seeds,
                                retain_graph=bool(retain_graph),
                                create_graph=bool(create_graph),
                                allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(variables, grads)]
    if arrays:
        from .ndarray.sparse import _from_coo
        from .numpy.multiarray import _wrap
        grads = [_from_coo(g) if g.is_sparse else _wrap(g) for g in grads]
    return grads[0] if single else grads


def get_symbol(x):
    """The reference returns the recorded graph as a Symbol; neither
    package has one for a recorded computation (reference: autograd.py
    ``get_symbol`` raises too)."""
    raise MXNetError("get_symbol: use hybridize() for graphs")


class _UserFunction(torch.autograd.Function):
    """The torch node of a :class:`Function` call: the user's forward,
    and the user's backward as its backward (first-order only)."""

    _first_order_only = True

    @staticmethod
    def forward(ctx, fn, arrays, *inputs):
        from .numpy.multiarray import _wrap
        ctx.fn, ctx.arrays = fn, arrays
        args = [_wrap(t) if arrays and isinstance(t, torch.Tensor) else t
                for t in inputs]
        with pause():
            out = fn.forward(*args)
        ctx.single = fn._single_out = not isinstance(out, (tuple, list))
        outs = [out] if ctx.single else list(out)
        return tuple(_raw(o) for o in outs)

    @staticmethod
    def backward(ctx, *gouts):
        from .numpy.multiarray import _wrap
        args = [_wrap(g) if ctx.arrays else g for g in gouts]
        with pause():
            grads = ctx.fn.backward(*args)
        if not isinstance(grads, (tuple, list)):
            grads = (grads,)
        return (None, None, *[None if g is None else _raw(g)
                              for g in grads])


class Function:
    """A differentiable function with a hand-written backward (reference:
    autograd.py ``Function``): subclass, write ``forward(self, *inputs)``
    and ``backward(self, *output_grads)`` on arrays (``mx.np`` arrays or
    tensors, as the call is given), and call an instance. Inside
    ``record()`` the call is one node whose gradient is ``backward``'s;
    ``save_for_backward`` / ``saved_tensors`` keep what ``backward``
    reads. The backward is first-order only: ``grad(create_graph=True)``
    through it raises, as the reference's does."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def __call__(self, *inputs):
        from .numpy.multiarray import _wrap, ndarray
        arrays = any(type(a) is ndarray for a in inputs)
        raw = [_raw(a) if type(a) is ndarray else a for a in inputs]
        outs = _UserFunction.apply(self, arrays, *raw)
        if not isinstance(outs, tuple):
            outs = (outs,)
        if arrays:
            outs = tuple(_wrap(o) for o in outs)
        single = len(outs) == 1 and getattr(self, "_single_out", True)
        return outs[0] if single else outs

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError
