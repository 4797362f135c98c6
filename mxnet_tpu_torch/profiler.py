"""mx.profiler.

Reference parity: python/mxnet/profiler.py (:30-360 — set_config/set_state/
dump, Domain/Task/Counter/Marker/Frame objects) over src/profiler/profiler.h
(engine-integrated per-op spans, chrome://tracing JSON dump).

Port of ``mxnet_tpu/profiler.py``; two layers —
1. Device profiling: ``set_config(tensorboard_dir=...)`` with
   ``set_state("run")`` starts a ``torch.profiler.profile`` over the CPU
   and, with a card, CUDA activities (where the reference starts
   ``jax.profiler.start_trace``); ``"stop"`` exports its Chrome trace
   (the card's kernels and copies by name, beside the host's runtime
   calls) into that directory as ``<host>_<pid>.<ms>.pt.trace.json``
   (the name TensorBoard's PyTorch profiler plugin reads), kept in
   ``device_trace_file()``. A device trace that cannot start or export
   raises. While it runs, every host span also enters
   ``torch.profiler.record_function`` (the reference's
   ``jax.profiler.TraceAnnotation``), so host spans line up with the
   device timeline; outside a device trace spans enter nothing, since
   ``record_function`` is not free.
2. Host-side op spans: the eager dispatcher, the layers' ops and
   cached-graph calls are timed here (``_hooks``); dump() writes
   chrome://tracing JSON like the reference. A span times host work: a
   kernel launch is asynchronous, so a span around it measures the launch,
   and the device time is in the device trace.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

from .base import MXNetError

_config = {"filename": "profile.json", "profile_all": False,
           "profile_symbolic": True, "profile_imperative": True,
           "profile_memory": False, "profile_api": False,
           "aggregate_stats": False}
_state = {"running": False, "device_trace_dir": None,
          "device_trace": None, "device_trace_file": None}
_events = []
_lock = threading.Lock()


def now_us():
    """Monotonic microseconds — THE clock of the host observability
    plane: profiler events, ``mx.trace`` spans and DataLoader-worker
    spans all stamp from here (CLOCK_MONOTONIC, system-wide on Linux),
    so aggregate tables and trace exports line up."""
    return time.perf_counter_ns() // 1000


def set_config(**kwargs):
    """Reference: profiler.py set_config (filename, profile_all, ...)."""
    _config.update(kwargs)
    from . import _hooks
    _hooks.refresh()


def set_state(state="stop", profile_process="worker"):
    """'run' | 'stop' (reference: profiler.py set_state).

    'run' also arms ``mx.telemetry`` when it is off, so one call captures
    host spans, the device trace AND the metrics registry; 'stop' disarms
    telemetry only if this bridge armed it (an explicit
    ``telemetry.enable()`` survives profiler stop/start cycles)."""
    from . import telemetry as _telemetry
    if state == "run":
        # the device trace first: one that cannot start raises before
        # anything else changed
        tracedir = _config.get("tensorboard_dir")
        if tracedir and not _state["device_trace_dir"]:
            _start_device_trace(tracedir)
        _state["running"] = True
        if not _telemetry.active():
            _telemetry.enable()
            _state["telemetry_autostart"] = True
    elif state == "stop":
        if _state.get("device_trace_dir"):
            _stop_device_trace()
        _state["running"] = False
        if _state.pop("telemetry_autostart", False):
            _telemetry.disable()
    else:
        raise MXNetError(f"unknown profiler state {state!r}")
    from . import _hooks
    _hooks.refresh()


def _start_device_trace(tracedir):
    """Start ``torch.profiler`` over the CPU and (with a card) CUDA
    activities; an error starting it propagates."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(tracedir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    _state["device_trace"] = prof
    _state["device_trace_dir"] = tracedir


def _stop_device_trace():
    """Stop the device trace and export it as a Chrome trace into its
    directory; the file's path is kept in ``device_trace_file()``."""
    import socket
    prof = _state["device_trace"]
    tracedir = _state["device_trace_dir"]
    _state["device_trace"] = None
    _state["device_trace_dir"] = None
    prof.stop()
    path = os.path.join(tracedir, f"{socket.gethostname()}_{os.getpid()}."
                                  f"{int(time.time() * 1000)}.pt.trace.json")
    prof.export_chrome_trace(path)
    if not os.path.getsize(path):
        raise MXNetError(f"the device trace {path} is empty")
    _state["device_trace_file"] = path
    return path


def device_trace_file():
    """Path of the last device trace exported by ``set_state("stop")``
    (None before the first)."""
    return _state["device_trace_file"]


def is_running():
    return _state["running"]


def record_event(name, category, start_us, dur_us, args=None):
    """Internal hook used by dispatch layers and the Task/Counter/Marker/
    Event objects. Gated on the running state: instrumentation left in
    place while the profiler is stopped must not accumulate events
    (the reference's objects no-op the same way when unconfigured)."""
    if not _state["running"]:
        return
    enclosing = current_scope()
    if enclosing:
        args = dict(args or {})
        args.setdefault("scope", enclosing)
    with _lock:
        _events.append({"name": name, "cat": category, "ph": "X",
                        "ts": start_us, "dur": dur_us, "pid": os.getpid(),
                        "tid": threading.get_ident(), "args": args or {}})


def _record_function(name):
    import torch
    return torch.profiler.record_function(name)


class _Span:
    def __init__(self, name, category="op"):
        self.name, self.category = name, category

    def __enter__(self):
        self._t0 = now_us()
        self._rf = None
        if _state["device_trace_dir"]:
            self._rf = _record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if _state["running"]:
            record_event(self.name, self.category, self._t0,
                         now_us() - self._t0)


def span(name, category="op"):
    return _Span(name, category)


def dump(finished=True, profile_process="worker"):
    """Write chrome://tracing JSON (reference: profiler.py dump /
    Profiler::DumpProfile profiler.h:304)."""
    with _lock:
        events = list(_events)
        if finished:
            _events.clear()
    with open(_config["filename"], "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return _config["filename"]


#: dumps() sort keys -> aggregate-row field
_SORT_KEYS = {"total": "total_ms", "avg": "avg_ms", "max": "max_ms",
              "calls": "calls", "name": "name"}


def dumps(reset=False, format="table", sort_by="total", ascending=False):  # noqa: A002
    """Aggregate stats (reference: profiler.py dumps, which honored the
    same format/sort_by/ascending knobs).  ``format='table'`` renders the
    human-readable text; ``format='json'`` returns machine-readable
    aggregate rows (name/calls/total_ms/avg_ms/max_ms) so dashboards and
    tests stop re-parsing the table."""
    if sort_by not in _SORT_KEYS:
        raise MXNetError(f"dumps(sort_by={sort_by!r}): expected one of "
                         f"{sorted(_SORT_KEYS)}")
    if format not in ("table", "json"):
        raise MXNetError(f"dumps(format={format!r}): expected 'table' "
                         "or 'json'")
    with _lock:
        events = list(_events)
        if reset:
            _events.clear()
    agg = {}
    for e in events:
        a = agg.setdefault(e["name"], [0, 0.0, 0.0])
        a[0] += 1
        a[1] += e["dur"] / 1000.0
        a[2] = max(a[2], e["dur"] / 1000.0)
    rows = [{"name": name, "calls": calls,
             "total_ms": round(total, 6),
             "avg_ms": round(total / calls, 6) if calls else 0.0,
             "max_ms": round(mx, 6)}
            for name, (calls, total, mx) in agg.items()]
    rows.sort(key=lambda r: r[_SORT_KEYS[sort_by]], reverse=not ascending)
    if format == "json":
        return json.dumps({"aggregates": rows})
    lines = [f"{'Name':40s} {'Calls':>8s} {'Total(ms)':>12s} "
             f"{'Avg(ms)':>10s} {'Max(ms)':>10s}"]
    for r in rows:
        lines.append(f"{r['name']:40.40s} {r['calls']:8d} "
                     f"{r['total_ms']:12.3f} {r['avg_ms']:10.3f} "
                     f"{r['max_ms']:10.3f}")
    return "\n".join(lines)


def pause(profile_process="worker"):
    _state["running"] = False
    from . import _hooks
    _hooks.refresh()


def resume(profile_process="worker"):
    _state["running"] = True
    from . import _hooks
    _hooks.refresh()


# -- structured objects (reference: profiler.py Domain/Task/Counter/Marker) --

class Domain:
    def __init__(self, name):
        self.name = name


class Task:
    def __init__(self, domain, name):
        self.domain, self.name = domain, name
        self._t0 = None

    def start(self):
        self._t0 = now_us()

    def stop(self):
        if self._t0 is not None:
            record_event(self.name, f"task:{self.domain.name}",
                         self._t0, now_us() - self._t0)


Frame = Task


class Counter:
    def __init__(self, domain, name, value=0):
        self.domain, self.name, self.value = domain, name, value

    def set_value(self, value):
        self.value = value
        record_event(self.name, f"counter:{self.domain.name}",
                     now_us(), 0, {"value": value})

    def increment(self, delta=1):
        self.set_value(self.value + delta)

    def decrement(self, delta=1):
        self.set_value(self.value - delta)


class Marker:
    def __init__(self, domain, name):
        self.domain, self.name = domain, name

    def mark(self, scope="process"):
        record_event(self.name, f"marker:{self.domain.name}",
                     now_us(), 0)


class Event:
    """Standalone timed event (reference profiler.py Event over
    ProfileEvent): start()/stop() records one span."""

    def __init__(self, name):
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = now_us()

    def stop(self):
        if self._t0 is not None:
            record_event(self.name, "event", self._t0,
                         now_us() - self._t0)
            self._t0 = None


_scope_tls = threading.local()


def current_scope():
    """Innermost active ``scope()`` name on this thread ('' outside any)."""
    stack = getattr(_scope_tls, "stack", None)
    return stack[-1] if stack else ""


@contextlib.contextmanager
def scope(name="<unk>:", append_mode=False):
    """Profiler scope naming everything recorded inside it (reference
    profiler.py scope — the GPU memory profiler used it to tag
    allocations).  Events recorded inside carry the scope in their args;
    ``append_mode=True`` nests under the enclosing scope
    (``outer:inner``) instead of replacing it, matching the reference's
    append semantics."""
    base = name.rstrip(":")
    stack = getattr(_scope_tls, "stack", None)
    if stack is None:
        stack = _scope_tls.stack = []
    if append_mode and stack:
        base = stack[-1] + ":" + base
    stack.append(base)
    try:
        with span(base, "scope"):
            yield
    finally:
        stack.pop()


def profiler_set_config(mode="symbolic", filename="profile.json"):
    """Deprecated 1.x spelling of set_config (reference profiler.py:73)."""
    import warnings
    warnings.warn("profiler.profiler_set_config() is deprecated; use "
                  "profiler.set_config()", DeprecationWarning, stacklevel=2)
    set_config(profile_symbolic=(mode in ("symbolic", "all")),
               profile_all=(mode == "all"), filename=filename)


def profiler_set_state(state="stop"):
    """Deprecated 1.x spelling of set_state (reference profiler.py:112)."""
    import warnings
    warnings.warn("profiler.profiler_set_state() is deprecated; use "
                  "profiler.set_state()", DeprecationWarning, stacklevel=2)
    set_state(state)


def dump_profile():
    """Deprecated spelling of dump (reference profiler.py:146)."""
    import warnings
    warnings.warn("profiler.dump_profile() is deprecated; use "
                  "profiler.dump()", DeprecationWarning, stacklevel=2)
    dump(True)
