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
- ``grad(create_graph=True)`` (higher-order gradients) is not part of
  this slice of the port and raises.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "backward", "grad"]

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


def _as_list(x):
    if x is None:
        return None
    return [x] if isinstance(x, torch.Tensor) else list(x)


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
    return "write" if param is None else param.grad_req


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into every leaf they reach, by ``grad_req``
    (reference: autograd.py ``backward``): "write" leaves get the fresh
    gradient, "add" leaves accumulate. ``train_mode`` is accepted for the
    reference's signature; the mode was fixed when the heads were
    recorded."""
    heads = _as_list(heads)
    seeds = _seeds(heads, _as_list(head_grads))
    for leaf in _leaves(heads):
        if _grad_req(leaf) == "write":
            leaf.grad = None  # torch then assigns instead of accumulating
    torch.autograd.backward(heads, seeds, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, without
    touching any ``.grad`` (reference: autograd.py ``grad``). A variable
    the heads do not reach gets zeros."""
    if create_graph:
        raise MXNetError("grad(create_graph=True) (higher-order gradients) "
                         "is not part of this slice of the port")
    single = isinstance(variables, torch.Tensor)
    variables = _as_list(variables)
    heads = _as_list(heads)
    seeds = _seeds(heads, _as_list(head_grads))
    grads = torch.autograd.grad(heads, variables, seeds,
                                retain_graph=bool(retain_graph),
                                allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(variables, grads)]
    return grads[0] if single else grads
