"""mx.blackbox — always-on flight recorder + crash-triggered postmortems.

The three live observability planes — ``mx.telemetry`` (metrics),
``mx.trace`` (spans), ``mx.insight`` (attribution/drift) — are all
in-memory: the moment ``mx.fault`` kills a worker, ``mx.fleet`` declares
a ``WorkerLost`` or a real SIGKILL/OOM lands, the evidence dies with the
process.  This module is the durable flipside: a bounded flight recorder
that, on any terminal trigger, freezes the last-N window of evidence into
ONE crash-atomic checksummed postmortem bundle a *surviving* host can
read.

- **Gate**: the same one-attr-read disabled design as ``fault._active`` /
  ``telemetry._active`` — every hook is ``if blackbox._active: ...``, and
  benchmark/telemetry_overhead.py re-gates the <2% disabled budget with a
  blackbox probe.
- **Triggers**: uncaught exceptions (chained ``sys.excepthook`` +
  ``threading.excepthook``, so a loader thread's death is captured too),
  ``resilience`` SIGTERM/SIGINT preemption (SystemExit never reaches an
  excepthook, so the exit-75 path dumps explicitly), ``WorkerLost``,
  trainer non-finite-grad escalation, ``insight.drift`` firing, and
  explicit :func:`dump`.
- **Bundle**: ``blackbox-<rank>-<step>.json`` under ``blackbox.dir``
  (default: next to the fleet heartbeat leases, so peers can read a dead
  host's bundle) written via ``serialization.atomic_write_bytes`` + a
  ``.sha256`` sidecar; torn bundles are detectable and skipped.  Content:
  the newest-N ``mx.trace`` spans (shared CLOCK_MONOTONIC base, so
  per-host bundles interleave into one fleet timeline), a full
  ``telemetry.snapshot()`` plus a counter delta since arming, the bounded
  telemetry event ring (python warnings + log records >= WARNING),
  ``fault.stats()``, the insight attribution/drift state, sync_guard
  per-site counts, every resolved config knob, and the caller-fed context
  (active MeshConfig, last checkpoint generation).
- **SIGKILL/OOM**: no hook runs, so a low-frequency shadow snapshot
  (``blackbox.checkpoint_interval``) rides ``HealthPlane.beat`` — the
  fleet always holds a <=interval-stale bundle per host.
- **Read side**: ``FleetSupervisor`` attaches the dead host's latest
  bundle to its ``fleet.degrade`` decision, ``tools/postmortem.py``
  merges per-host bundles into one causal timeline (first-anomaly host
  highlighted), and the ops endpoint serves ``/postmortem?last=N``.

Enable via ``mx.blackbox.enable()`` or ``MXNET_BLACKBOX=1`` (the
``blackbox.enable`` knob, read at import like ``MXNET_FAULT_SPEC``).
Docs: docs/OBSERVABILITY.md "Postmortem forensics".

Port of ``mxnet_tpu/blackbox.py``: bundles go through the port's
``serialization`` (atomic write, ``.sha256`` sidecar) with the
reference's schema, triggers, retention and read side, and carry a
``device`` section: the card's name (``torch.cuda.get_device_name``),
its allocator's memory gauges (live, peak, limit: the ``memory.*`` gauges
of ``telemetry.record_memory``) and ``torch.version.cuda``. Framework log
records are captured from the ``mxnet_tpu_torch`` loggers.
"""
from __future__ import annotations

import json
import logging
import os
import re
import sys
import threading
import time
import traceback
import warnings as _warnings

from . import config as _config
from . import fault as _fault
from . import telemetry as _telemetry
from . import trace as _trace
from .base import MXNetError

__all__ = ["enable", "disable", "configure", "active", "dump", "collect",
           "maybe_checkpoint", "set_context", "note_mesh",
           "note_checkpoint", "bundle_dir", "list_bundles", "latest_bundle",
           "read_bundle", "endpoint_report", "BUNDLE_SCHEMA", "TRIGGERS"]

#: bundle format tag — readers reject documents without it
BUNDLE_SCHEMA = "mx.blackbox/1"

#: terminal trigger classes a bundle's ``meta.trigger`` may carry
TRIGGERS = ("excepthook", "thread_excepthook", "preempt", "worker_lost",
            "nonfinite", "drift", "shadow", "manual")

_lock = threading.Lock()
#: hot-path gate — trigger sites read this one attribute; False keeps
#: every hook a single no-op branch (same design as fault._active)
_active = False

#: caller-fed forensic context (rank, step, MeshConfig, checkpoint
#: generation, ...) embedded verbatim in every bundle
_context: dict = {}
#: counter values at enable() time — bundles carry the delta, so "what
#: happened during THIS run" survives a long-lived registry
_baseline: dict = {}
_snap_last = 0.0
_last_exc_id = None

_prev_excepthook = None
_prev_threading_hook = None
_prev_showwarning = None
_log_handler = None

_telemetry.declare_metric(
    "blackbox.bundles_written_total", "counter",
    "postmortem bundles written by the flight recorder, by trigger")
_telemetry.declare_metric(
    "blackbox.dump_errors_total", "counter",
    "bundle writes that failed (best-effort: a dying process must not "
    "die harder)")
_telemetry.declare_metric(
    "blackbox.last_dump_unix", "gauge",
    "wall-clock time of the last postmortem bundle written")


# -- capture hooks ----------------------------------------------------------

class _RingHandler(logging.Handler):
    """Routes framework log records >= WARNING into the bounded
    telemetry event ring, so bundles carry the log lines that preceded
    the crash."""

    def emit(self, record):
        try:
            _telemetry.note_event("log", record.getMessage(),
                                  logger=record.name,
                                  level=record.levelname)
        except Exception:   # noqa: BLE001 - logging must never raise
            pass


def _showwarning(message, category, filename, lineno,
                 file=None, line=None):
    try:
        _telemetry.note_event("warning", message,
                              category=category.__name__,
                              filename=filename, lineno=lineno)
    except Exception:   # noqa: BLE001 - warning capture must never raise
        pass
    if _prev_showwarning is not None:
        _prev_showwarning(message, category, filename, lineno,
                          file=file, line=line)


def _dump_exc(trigger, exc_type, exc, tb, **extra):
    """One bundle per exception object, no matter how many hooks see
    it (sys.excepthook and threading.excepthook can chain)."""
    global _last_exc_id
    if not _active:
        return
    with _lock:
        if exc is not None and id(exc) == _last_exc_id:
            return
        _last_exc_id = id(exc)
    name = getattr(exc_type, "__name__", str(exc_type))
    reason = f"{name}: {exc}"
    if extra:
        reason += " (" + ", ".join(
            f"{k}={v}" for k, v in sorted(extra.items())) + ")"
    dump(trigger=trigger, reason=reason, exc=exc)


def _excepthook(exc_type, exc, tb):
    _dump_exc("excepthook", exc_type, exc, tb)
    if _prev_excepthook is not None:
        _prev_excepthook(exc_type, exc, tb)


def _threading_hook(args):
    if args.exc_type is not SystemExit:
        _dump_exc("thread_excepthook", args.exc_type, args.exc_value,
                  args.exc_traceback,
                  thread=getattr(args.thread, "name", None))
    if _prev_threading_hook is not None:
        _prev_threading_hook(args)


# -- switches ---------------------------------------------------------------

def enable(on=True):
    """Arm/disarm the recorder.  Arming chains the sys/threading
    excepthooks, installs the warnings/log capture into the telemetry
    event ring, snapshots the counter baseline, and arms the pipeline
    sync-site counter; disarming restores the previous hooks."""
    global _active, _prev_excepthook, _prev_threading_hook, \
        _prev_showwarning, _log_handler, _baseline
    on = bool(on)
    with _lock:
        if on == _active:
            return _active
        _active = on
        if on:
            _baseline = _telemetry.counters()
            _prev_excepthook = sys.excepthook
            sys.excepthook = _excepthook
            _prev_threading_hook = threading.excepthook
            threading.excepthook = _threading_hook
            _prev_showwarning = _warnings.showwarning
            _warnings.showwarning = _showwarning
            _log_handler = _RingHandler(level=logging.WARNING)
            logging.getLogger("mxnet_tpu_torch").addHandler(_log_handler)
        else:
            if sys.excepthook is _excepthook:
                sys.excepthook = _prev_excepthook
            if threading.excepthook is _threading_hook:
                threading.excepthook = _prev_threading_hook
            if _warnings.showwarning is _showwarning:
                _warnings.showwarning = _prev_showwarning
            if _log_handler is not None:
                logging.getLogger("mxnet_tpu_torch").removeHandler(
                    _log_handler)
                _log_handler = None
            _prev_excepthook = None
            _prev_threading_hook = None
            _prev_showwarning = None
    from . import pipeline as _pipeline   # lazy: pipeline imports telemetry
    _pipeline.arm_site_counts("blackbox", on)
    return _active


def disable():
    enable(False)


def configure():
    """Re-read the ``blackbox.enable`` knob / ``MXNET_BLACKBOX`` alias."""
    return enable(_config.get("blackbox.enable"))


def active():
    return _active


# -- forensic context -------------------------------------------------------

def set_context(**fields):
    """Merge caller-known facts (rank=, step=, ...) into the context
    block every subsequent bundle embeds.  ``None`` deletes a key."""
    with _lock:
        for k, v in fields.items():
            if v is None:
                _context.pop(k, None)
            else:
                _context[k] = v
        return dict(_context)


def note_mesh(cfg):
    """Record the active parallelism layout (a MeshConfig or any object
    with dp/tp/pp attrs) — bundles answer 'what mesh was this host
    running?' without the supervisor."""
    if not _active:
        return
    mesh = {}
    for attr in ("dp", "tp", "pp", "sp", "zero"):
        v = getattr(cfg, attr, None)
        if v is not None:
            mesh[attr] = v
    set_context(mesh=mesh or repr(cfg))


def note_checkpoint(path, step, generation=None):
    """Record the last TrainState bundle written — the postmortem names
    the exact checkpoint a replacement host will restore."""
    if not _active:
        return
    set_context(checkpoint={"path": str(path), "step": int(step),
                            "generation": generation})


# -- bundle writing ---------------------------------------------------------

def _device():
    """The bundle's device section: the card, its memory, the CUDA
    build (read from the allocator's host counters: no sync)."""
    import torch
    out = {"name": "cpu", "cuda": torch.version.cuda, "memory": {}}
    if torch.cuda.is_available():
        out["name"] = torch.cuda.get_device_name(0)
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out["memory"][str(i)] = {
                "live": int(stats.get("allocated_bytes.all.current", 0)),
                "peak": int(stats.get("allocated_bytes.all.peak", 0)),
                "limit": int(torch.cuda.mem_get_info(i)[1])}
    return out


def _json_safe(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return repr(v)


def collect(trigger="manual", reason=None, exc=None, step=None, rank=None,
            shadow=False):
    """Assemble (without writing) one postmortem bundle dict: the
    last-N evidence window across every observability plane."""
    window = max(1, int(_config.get("blackbox.window")))
    with _lock:
        ctx = dict(_context)
        baseline = dict(_baseline)
    if rank is None:
        rank = int(ctx.get("rank", 0))
    if step is None:
        step = int(ctx.get("step", 0))
    snap = _telemetry.snapshot()
    delta = {}
    for k, v in snap["counters"].items():
        d = v - baseline.get(k, 0)
        if d:
            delta[k] = d
    from . import insight as _insight   # lazy: insight imports telemetry
    try:
        insight_state = {"summary": _insight.last_summary(),
                         "drift_events": _insight.drift_events()}
    except Exception:   # noqa: BLE001 - evidence is best-effort
        insight_state = {"summary": None, "drift_events": []}
    from . import pipeline as _pipeline
    bundle = {
        "schema": BUNDLE_SCHEMA,
        "meta": {"trigger": trigger, "reason": reason,
                 "shadow": bool(shadow), "rank": int(rank),
                 "step": int(step), "pid": os.getpid(),
                 "time": time.time(), "clock_us": _trace.clock_us()},
        "exception": None,
        "spans": _trace.spans(last=window),
        "trace_stats": _trace.stats(),
        "telemetry": snap,
        "counters_delta": delta,
        "events": _telemetry.events(last=window),
        "fault": _fault.stats(),
        "insight": insight_state,
        "sync_sites": _pipeline.sync_site_counts(),
        "config": {name: _json_safe(k.value())
                   for name, k in sorted(_config.knobs().items())},
        "context": ctx,
        "device": _device(),
    }
    if exc is not None:
        bundle["exception"] = {
            "type": type(exc).__name__, "message": str(exc),
            "traceback": traceback.format_exception(
                type(exc), exc, exc.__traceback__)}
    return bundle


def bundle_dir():
    """The resolved bundle directory: ``blackbox.dir``, else the fleet
    lease dir (so surviving hosts can read a dead peer's bundle), else
    '' (dumps are skipped)."""
    return _config.get("blackbox.dir") or _config.get("fleet.lease_dir") \
        or ""


def dump(trigger="manual", reason=None, exc=None, step=None, rank=None,
         shadow=False, dir=None):
    """Write ONE crash-atomic checksummed postmortem bundle
    ``blackbox-<rank>-<step>.json`` and run per-rank retention
    (``blackbox.keep``).  Returns the path, or None without a resolvable
    directory.  Never raises — a dying process must not die harder."""
    global _last_exc_id
    d = dir or bundle_dir()
    if not d:
        return None
    if exc is not None:
        # an explicit dump for this exception supersedes the excepthook
        # one it would otherwise get when it escapes (e.g. WorkerLost
        # after the restart budget is exhausted)
        with _lock:
            _last_exc_id = id(exc)
    try:
        bundle = collect(trigger=trigger, reason=reason, exc=exc,
                         step=step, rank=rank, shadow=shadow)
        rank = bundle["meta"]["rank"]
        step = bundle["meta"]["step"]
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"blackbox-{rank}-{step:08d}.json")
        from . import serialization as _ser
        _ser.atomic_write_bytes(
            path, (json.dumps(bundle) + "\n").encode("utf-8"))
        _ser.write_checksum(path)
        if _fault.fire("blackbox.torn_bundle", step=step):
            # crash mid-write analog: the data file is truncated AFTER
            # its checksum landed, so verify_checksum must reject it
            with open(path, "r+b") as f:
                f.truncate(max(1, os.path.getsize(path) // 2))
        _gc(d, rank)
        if _telemetry._active:
            _telemetry.inc("blackbox.bundles_written_total",
                           trigger=trigger)
            _telemetry.set_gauge("blackbox.last_dump_unix",
                                 bundle["meta"]["time"])
        return path
    except Exception:   # noqa: BLE001 - best-effort by contract
        try:
            if _telemetry._active:
                _telemetry.inc("blackbox.dump_errors_total")
        except Exception:   # noqa: BLE001
            pass
        return None


def _gc(d, rank):
    """Keep the newest ``blackbox.keep`` bundles for ``rank`` (plus
    sidecars); 0 keeps everything."""
    keep = int(_config.get("blackbox.keep"))
    if keep <= 0:
        return
    from . import serialization as _ser
    mine = list_bundles(d, rank=rank)
    for p in mine[:-keep]:
        for victim in (p, p + _ser.CHECKSUM_SUFFIX):
            try:
                os.remove(victim)
            except OSError:
                pass


def maybe_checkpoint(lease_dir=None, rank=0, step=None, interval=None):
    """Rate-limited shadow :func:`dump` — the ``HealthPlane.beat`` hook
    (no thread of its own).  SIGKILL/OOM run no excepthook; this keeps a
    <=``blackbox.checkpoint_interval``-stale bundle per host anyway."""
    global _snap_last
    if not _active:
        return None
    if interval is None:
        interval = float(_config.get("blackbox.checkpoint_interval"))
    if interval <= 0:
        return None
    now = time.monotonic()
    with _lock:
        if now - _snap_last < interval:
            return None
        _snap_last = now
    d = _config.get("blackbox.dir") or lease_dir or \
        _config.get("fleet.lease_dir")
    return dump(trigger="shadow", step=step, rank=rank, shadow=True,
                dir=d)


# -- bundle reading ---------------------------------------------------------

_BUNDLE_RE = re.compile(r"^blackbox-(\d+)-(\d+)\.json$")


def list_bundles(dir=None, rank=None):
    """Bundle paths in ``dir`` (default: the resolved bundle dir),
    oldest first by (mtime, name); ``rank`` filters to one host.  No
    integrity check — see :func:`latest_bundle` / :func:`read_bundle`."""
    d = dir or bundle_dir()
    if not d or not os.path.isdir(d):
        return []
    out = []
    for name in os.listdir(d):
        m = _BUNDLE_RE.match(name)
        if not m:
            continue
        if rank is not None and int(m.group(1)) != int(rank):
            continue
        out.append(os.path.join(d, name))
    out.sort(key=lambda p: (os.path.getmtime(p), p))
    return out


def read_bundle(path):
    """Parse one bundle with integrity checks: the ``.sha256`` sidecar
    must verify, the JSON must parse, and the schema tag must match.
    Raises :class:`MXNetError` on a torn or foreign file."""
    from . import serialization as _ser
    _ser.verify_checksum(path, required=True)
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except ValueError as e:
        raise MXNetError(f"torn postmortem bundle {path}: {e}") from e
    if not isinstance(doc, dict) or doc.get("schema") != BUNDLE_SCHEMA \
            or "meta" not in doc:
        raise MXNetError(
            f"{path} is not a {BUNDLE_SCHEMA} postmortem bundle")
    return doc


def latest_bundle(dir=None, rank=None):
    """Path of the newest bundle for ``rank`` that passes integrity
    checks (torn bundles are skipped, not fatal); None when the host
    left no readable evidence."""
    for path in reversed(list_bundles(dir, rank=rank)):
        try:
            read_bundle(path)
        except (MXNetError, OSError):
            continue
        return path
    return None


def endpoint_report(last=None, dir=None):
    """The ``/postmortem?last=N`` document: newest-first metadata of
    the bundles in the resolved directory (torn ones flagged, never
    fatal)."""
    d = dir or bundle_dir()
    out = {"active": _active, "dir": d or None, "bundles": []}
    paths = list_bundles(d) if d else []
    if last is not None:
        paths = paths[-max(0, int(last)):]
    for path in reversed(paths):
        entry = {"path": path}
        try:
            entry["bytes"] = os.path.getsize(path)
        except OSError:
            entry["bytes"] = None
        try:
            meta = read_bundle(path)["meta"]
            entry["valid"] = True
            entry.update({k: meta.get(k) for k in
                          ("trigger", "reason", "rank", "step", "time",
                           "shadow")})
        except (MXNetError, OSError) as e:
            entry["valid"] = False
            entry["error"] = str(e)
        out["bundles"].append(entry)
    return out


# arm from the environment at import (MXNET_BLACKBOX=1), mirroring
# fault.py, so spawned workers and plain scripts inherit the switch
if _config.get("blackbox.enable"):
    enable()
