"""The host planes' per-op hooks, for ``_invoke`` and the layers' ops.

In the reference every layer reaches ``_invoke``
(``mxnet_tpu/numpy/multiarray.py:151``), whose three hooks run in this
order: a profiler ``"operator"`` span named by the op, the
``invoke.nan_output`` fault probe (a hit rebinds the first inexact output
to all-NaN) and the ``invoke.ops_total`` counter. The port's layers and
model zoo call the undecorated tensor ops of ``numpy_extension.tensor_ops``
instead, so this module gives both the same hooks under the reference's
op names.

- :data:`on` is true only while the profiler runs (with
  ``profile_imperative``), telemetry records or a fault spec is armed. The
  switches of those planes call :func:`refresh`. With every plane off,
  ``_invoke`` reads :data:`on` once, and the layers call the undecorated
  ops: ``refresh`` swaps ``tensor_ops`` between them and their hooked
  versions (``numpy_extension._set_hooked``).
- Hybridized calls follow the reference's rule, which counts a block's ops
  once per traced signature: :func:`tracing` marks the one run of a new
  signature whose ops count (the warm-up of a capture on the card, the
  first call on the CPU), where ``invoke.nan_output`` is probed but never
  applied (corrupting there would bake NaN into every replay, as the
  reference's tracer check prevents), and :func:`silent` marks the runs
  whose ops do not count (a capture, a later CPU call of a known
  signature). A probe never corrupts while the current CUDA stream
  captures either.
- The hooks run on the host only: a span is host time (the launch, not
  the kernel; the device time is in the profiler's device trace), and no
  hook calls a CUDA API that a capture refuses.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["on", "register", "refresh", "call", "corrupt", "tracing", "silent"]

#: the one gate: True while the profiler, telemetry or a fault spec is on
on = False

_tls = threading.local()
_listeners = []
_planes = None


def _modules():
    global _planes
    if _planes is None:
        from . import fault, profiler, telemetry
        _planes = (profiler, telemetry, fault)
    return _planes


def register(fn):
    """Call ``fn(on)`` now and whenever :data:`on` changes."""
    _listeners.append(fn)
    fn(on)


def refresh():
    """Recompute :data:`on` from the planes' switches."""
    global on
    profiler, telemetry, fault = _modules()
    now = bool((profiler._state["running"]
                and profiler._config["profile_imperative"])
               or telemetry._active or fault._active)
    if now != on:
        on = now
        for fn in _listeners:
            fn(now)
    return on


def _mode():
    return getattr(_tls, "mode", None)


@contextlib.contextmanager
def _scoped(mode):
    prev = getattr(_tls, "mode", None)
    _tls.mode = mode
    try:
        yield
    finally:
        _tls.mode = prev


def tracing():
    """Within the scope (this thread) ops count and probe, as under the
    reference's tracer, but an injected fault corrupts nothing."""
    return _scoped("trace")


def silent():
    """Within the scope (this thread) ops run without hooks."""
    return _scoped("silent")


def _first_inexact(out):
    if isinstance(out, torch.Tensor):
        return out if out.is_floating_point() or out.is_complex() else None
    if isinstance(out, (tuple, list)):
        for o in out:
            t = _first_inexact(o)
            if t is not None:
                return t
    return None


def _capturing(t):
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def corrupt(out):
    """``out`` with its first inexact tensor made all-NaN (reference:
    ``_nan_corrupt``). The NaN tensor keeps the op's autograd graph, as
    the reference keeps the op's tape entry, so its gradients are NaN
    too. A tensor being captured is left alone."""
    t = _first_inexact(out)
    if t is None or _capturing(t):
        return out
    bad = t + torch.full((), float("nan"), dtype=t.dtype, device=t.device)

    def swap(o):
        if o is t:
            return bad
        if isinstance(o, tuple) and hasattr(o, "_fields"):
            return type(o)(*[swap(x) for x in o])
        if isinstance(o, (tuple, list)):
            return type(o)(swap(x) for x in o)
        return o
    return swap(out)


def call(fn, name, args, kwargs, wrapped=False):
    """``fn(*args, **kwargs)`` under the three hooks, in the reference's
    order. ``wrapped``: the result holds ``ndarray``s (``_invoke``), whose
    first inexact one is rebound."""
    mode = _mode()
    if mode == "silent":
        return fn(*args, **kwargs)
    profiler, telemetry, fault = _modules()
    if profiler._state["running"] and profiler._config["profile_imperative"]:
        with profiler.span(name, "operator"):
            out = fn(*args, **kwargs)
    else:
        out = fn(*args, **kwargs)
    if fault._active and fault.fire("invoke.nan_output") \
            and mode != "trace":
        out = _corrupt_arrays(out) if wrapped else corrupt(out)
    if telemetry._active:
        telemetry.inc("invoke.ops_total")
    return out


def _corrupt_arrays(out):
    """Rebind the first inexact ``ndarray`` of an ``_invoke`` result."""
    from .numpy.multiarray import ndarray
    leaves = [out] if type(out) is ndarray else \
        [o for o in (out if isinstance(out, (tuple, list)) else ())
         if type(o) is ndarray]
    for leaf in leaves:
        t = leaf._data
        if (t.is_floating_point() or t.is_complex()) and not _capturing(t):
            leaf._data = corrupt(t)
            leaf._version += 1
            return out
    return out
