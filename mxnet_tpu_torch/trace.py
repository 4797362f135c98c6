"""mx.trace — end-to-end causal tracing with Perfetto export.

Where ``mx.telemetry`` aggregates (counters/histograms answer "how much,
on average"), ``mx.trace`` records *spans*: named, timed intervals with
parent/child links, so one slow serve request or one stalled train step
can be read end-to-end (enqueue → prefill → decode steps → drain;
data wait → h2d → dispatch → deferred drain).

Design points, mirroring the rest of the observability plane:

- **One-attr-read disabled fast path.** Every hook left in hot code is
  gated on the module-level ``_active`` bool; disabled, the cost is one
  attribute read (<2% budget, enforced by benchmark/telemetry_overhead.py
  and the CI ``trace`` stage).
- **Bounded ring buffer.** Finished spans land in a per-process deque
  capped by the ``trace.buffer`` knob; overflow drops oldest-first and
  counts into ``trace.dropped_total``.
- **One clock.** Timestamps are ``profiler.now_us()`` — the same
  CLOCK_MONOTONIC microsecond epoch ``profiler.record_event`` uses, so a
  trace export and a profiler dump line up, and (Linux) spans built in
  DataLoader worker processes land on the parent's timeline too.
- **Context propagation.** ``current_context()`` yields a portable
  ``(trace_id, span_id)`` pair; ``adopt``/``attach`` rebind it on
  background threads (DevicePrefetcher), and ``make_span``/``ingest``
  carry spans across process boundaries (DataLoader workers).
- **Perfetto/Chrome export.** The ring already holds Chrome trace-event
  dicts (``ph: "X"``); ``export(path)`` wraps them in ``traceEvents`` —
  load in ``ui.perfetto.dev`` or ``chrome://tracing`` as-is.  While the
  profiler is running, finished spans also mirror into its aggregate
  table (``profiler.dumps()``) under ``trace:<category>``, and when a
  device trace is armed (``set_config(tensorboard_dir=...)`` +
  ``set_state('run')``) ``span()`` brackets itself with
  ``torch.profiler.record_function`` so host spans align with the card's
  timeline in the device trace.

Port of ``mxnet_tpu/trace.py`` over the port's profiler: the ring,
context propagation, ``export`` and the profiler mirroring are the
reference's; the device-trace bracketing is ``record_function`` where the
reference enters ``jax.profiler.TraceAnnotation``.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading

from . import config as _config
from . import profiler as _profiler
from . import telemetry as _telemetry

__all__ = ["enable", "disable", "active", "configure", "span", "begin",
           "emit", "make_span", "ingest", "current_context", "adopt",
           "attach", "spans", "clear", "stats", "export", "clock_us",
           "SpanHandle"]

_telemetry.declare_metric(
    "trace.dropped_total", "counter",
    "spans evicted from the trace ring buffer (raise trace.buffer or "
    "export more often)")

#: the one-attr-read gate every instrumentation site checks first
_active = False

_lock = threading.Lock()
_events: collections.deque = collections.deque()
_capacity = max(1, int(_config.get("trace.buffer")))
_dropped = 0
_ids = itertools.count(1)
_tls = threading.local()

#: shared monotonic clock (μs) — the profiler's epoch, valid across
#: processes on Linux (CLOCK_MONOTONIC is system-wide).
clock_us = _profiler.now_us


def _new_id():
    return f"{os.getpid():x}.{next(_ids):x}"


def _stack():
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def current_context():
    """Portable ``(trace_id, span_id)`` of this thread's innermost span
    (None outside any span) — pass to ``adopt``/``attach``/``begin(
    parent=...)``/``make_span`` to parent work on another thread or in
    another process."""
    s = getattr(_tls, "stack", None)
    return tuple(s[-1]) if s else None


def adopt(ctx):
    """Make ``ctx`` the base trace context of the *current* thread (for
    the lifetime of the thread — background workers whose every span
    should parent to the consumer that spawned them)."""
    if ctx:
        _stack().append((ctx[0], ctx[1]))


@contextlib.contextmanager
def attach(ctx):
    """Scoped form of :func:`adopt`: spans opened inside parent to
    ``ctx``; the previous context is restored on exit."""
    if not ctx:
        yield
        return
    s = _stack()
    s.append((ctx[0], ctx[1]))
    try:
        yield
    finally:
        s.pop()


def _record(ev):
    global _dropped
    dropped = 0
    with _lock:
        _events.append(ev)
        while len(_events) > _capacity:
            _events.popleft()
            dropped += 1
        if dropped:
            _dropped += dropped
    if dropped and _telemetry._active:
        _telemetry.inc("trace.dropped_total", dropped)


def _finish(name, category, start_us, dur_us, trace_id, span_id,
            parent_id, attrs):
    args = dict(attrs) if attrs else {}
    args["trace_id"] = trace_id
    args["span_id"] = span_id
    if parent_id is not None:
        args["parent_id"] = parent_id
    _record({"name": name, "cat": category, "ph": "X", "ts": start_us,
             "dur": dur_us, "pid": os.getpid(),
             "tid": threading.get_ident(), "args": args})
    if _profiler.is_running():
        _profiler.record_event(name, "trace:" + category, start_us,
                               dur_us, dict(attrs) if attrs else None)


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _NoopSpan()


class _Span:
    """Context-manager span: nests via the thread-local context stack."""

    __slots__ = ("name", "category", "attrs", "trace_id", "span_id",
                 "parent_id", "_t0", "_rf", "_onstack")

    def __init__(self, name, category, attrs):
        self.name = name
        self.category = category
        self.attrs = attrs
        self.span_id = _new_id()
        self.trace_id = None
        self.parent_id = None
        self._rf = None
        self._onstack = False

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        s = _stack()
        if s:
            self.trace_id, self.parent_id = s[-1]
        else:
            self.trace_id = self.span_id
        s.append((self.trace_id, self.span_id))
        self._onstack = True
        if _profiler._state.get("device_trace_dir"):
            self._rf = _profiler._record_function(self.name)
            self._rf.__enter__()
        self._t0 = _profiler.now_us()
        return self

    def __exit__(self, *exc):
        t1 = _profiler.now_us()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self._onstack:
            st = getattr(_tls, "stack", None)
            if st:
                st.pop()
            self._onstack = False
        _finish(self.name, self.category, self._t0,
                max(0, t1 - self._t0), self.trace_id, self.span_id,
                self.parent_id, self.attrs)
        return False


def span(name, category="app", **attrs):
    """``with trace.span("train.step", step=n): ...`` — nested spans
    parent automatically through the thread-local context stack.  A
    cheap no-op object is returned while tracing is disabled."""
    if not _active:
        return _NOOP
    return _Span(name, category, attrs)


class SpanHandle:
    """Explicit begin/end span for async lifetimes (a serve request
    lives across many engine steps and ends on a different code path
    than it began).  Does not touch the thread-local stack; children
    parent to it via ``parent=handle.context``."""

    __slots__ = ("name", "category", "attrs", "trace_id", "span_id",
                 "parent_id", "_t0", "_done")

    def __init__(self, name, category, attrs, parent):
        self.name = name
        self.category = category
        self.attrs = attrs
        self.span_id = _new_id()
        if parent:
            self.trace_id, self.parent_id = parent
        else:
            self.trace_id, self.parent_id = self.span_id, None
        self._t0 = _profiler.now_us()
        self._done = False

    @property
    def context(self):
        return (self.trace_id, self.span_id)

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def end(self, **attrs):
        if self._done:
            return
        self._done = True
        if attrs:
            self.attrs.update(attrs)
        t1 = _profiler.now_us()
        _finish(self.name, self.category, self._t0,
                max(0, t1 - self._t0), self.trace_id, self.span_id,
                self.parent_id, self.attrs)


def begin(name, category="app", parent=None, **attrs):
    """Open an async span; returns a :class:`SpanHandle` (call
    ``.end()``), or None while tracing is disabled.  ``parent`` is a
    ``(trace_id, span_id)`` context (default: the current thread's)."""
    if not _active:
        return None
    return SpanHandle(name, category, attrs,
                      parent if parent is not None else current_context())


def emit(name, start_us, dur_us, parent=None, category="app", **attrs):
    """Record an already-timed span directly (per-decode-step spans whose
    wall time was measured anyway — no context-stack traffic)."""
    if not _active:
        return
    sid = _new_id()
    if parent is None:
        parent = current_context()
    if parent:
        trace_id, parent_id = parent
    else:
        trace_id, parent_id = sid, None
    _finish(name, category, int(start_us), max(0, int(dur_us)),
            trace_id, sid, parent_id, attrs)


def make_span(name, start_us, dur_us, parent, category="app", **attrs):
    """Build (without recording) one Chrome-trace span dict — for worker
    processes, which ship spans back to the parent in their result tuple
    for :func:`ingest`.  ``parent`` is the consumer's ``(trace_id,
    span_id)`` context; perf_counter is system-wide on Linux, so the
    timestamps land on the parent's timeline unadjusted."""
    sid = _new_id()
    args = dict(attrs)
    if parent:
        args["trace_id"], args["parent_id"] = parent[0], parent[1]
    else:
        args["trace_id"] = sid
    args["span_id"] = sid
    return {"name": name, "cat": category, "ph": "X", "ts": int(start_us),
            "dur": max(0, int(dur_us)), "pid": os.getpid(),
            "tid": threading.get_ident(), "args": args}


def ingest(spans_):
    """Append pre-built span dicts (from :func:`make_span` in another
    process) to this process's ring.  Returns the count ingested."""
    if not _active or not spans_:
        return 0
    for ev in spans_:
        _record(ev)
    return len(spans_)


def spans(last=None, category=None):
    """Snapshot of recorded spans, oldest first.  ``last=N`` keeps the
    newest N; ``category=`` filters on the span category first — the
    reader behind ``/trace?last=N&category=C``."""
    with _lock:
        out = list(_events)
    if category is not None:
        out = [ev for ev in out if ev.get("cat") == category]
    if last is not None and last >= 0:
        out = out[len(out) - min(last, len(out)):]
    return out


def clear():
    global _dropped
    with _lock:
        _events.clear()
        _dropped = 0


def stats():
    with _lock:
        n = len(_events)
    return {"active": _active, "recorded": n, "dropped": _dropped,
            "capacity": _capacity}


def export(path=None, last=None):
    """Write the ring as Chrome trace-event / Perfetto JSON.  Open the
    file in ui.perfetto.dev (or chrome://tracing); span links live in
    ``args`` (trace_id/span_id/parent_id)."""
    path = path or "mxtrace.json"
    with open(path, "w") as f:
        json.dump({"traceEvents": spans(last), "displayTimeUnit": "ms"},
                  f)
    return path


def enable(on=True, buffer=None):
    """Switch the recorder on (or off with ``on=False``); ``buffer``
    resizes the ring."""
    global _active, _capacity
    if buffer is not None:
        _capacity = max(1, int(buffer))
    _active = bool(on)
    return _active


def disable():
    return enable(False)


def active():
    return _active


def configure():
    """Re-read the ``trace.*`` knobs (after mx.config.set or an env
    change) — the spawn-worker arming path."""
    global _capacity
    _capacity = max(1, int(_config.get("trace.buffer")))
    return enable(_config.get("trace.enable"))


# Arm from the environment at import: spawned DataLoader workers inherit
# os.environ, so MXNET_TRACE=1 traces them too (same pattern as
# telemetry/fault).
if _config.get("trace.enable"):
    _active = True
