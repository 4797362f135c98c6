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
- ``grad(create_graph=True)`` (higher-order gradients) is not part of
  this slice of the port and raises.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "backward", "grad", "mark_variables"]

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


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into every leaf they reach, by ``grad_req``
    (reference: autograd.py ``backward``): "write" leaves get the fresh
    gradient, "add" leaves accumulate. ``train_mode`` is accepted for the
    reference's signature; the mode was fixed when the heads were
    recorded."""
    heads = _as_list(heads)
    seeds = _seeds(heads, _as_list(head_grads))
    added = []
    for leaf in _leaves(heads):
        req = _grad_req(leaf)
        if req == "add" and hasattr(leaf, "_mx_grad_req"):
            # an attached array's "add": out of place, after the backward
            added.append((leaf, leaf.grad))
            leaf.grad = None
        elif req == "write":
            leaf.grad = None  # torch then assigns instead of accumulating
    torch.autograd.backward(heads, seeds, retain_graph=retain_graph)
    for leaf, old in added:
        if old is not None:
            leaf.grad = old if leaf.grad is None else old + leaf.grad


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, without
    touching any ``.grad`` (reference: autograd.py ``grad``). A variable
    the heads do not reach gets zeros."""
    if create_graph:
        raise MXNetError("grad(create_graph=True) (higher-order gradients) "
                         "is not part of this slice of the port")
    single = isinstance(variables, torch.Tensor) or hasattr(variables,
                                                             "_data")
    arrays = hasattr(variables if single else next(iter(variables), None),
                     "_data")
    variables = _as_list(variables)
    heads = _as_list(heads)
    seeds = _seeds(heads, _as_list(head_grads))
    grads = torch.autograd.grad(heads, variables, seeds,
                                retain_graph=bool(retain_graph),
                                allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(variables, grads)]
    if arrays:
        from .numpy.multiarray import _wrap
        grads = [_wrap(g) for g in grads]
    return grads[0] if single else grads
