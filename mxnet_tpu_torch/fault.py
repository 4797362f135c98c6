"""mx.fault — deterministic fault injection + resilience event accounting.

Copy of ``mxnet_tpu/fault.py`` (the port imports nothing of the JAX
package): the same ``POINTS``, whole (a point whose site is not ported
yet can still be armed), spec grammar, counters and seeded per-point
``random.Random`` streams, so one spec fires at the same probes in both
packages. Arming and clearing refresh the per-op hooks' gate
(``_hooks.refresh``).

Reference parity: none — the reference's failure story is "async errors
rethrow at the next sync point".  Production TPU training (preemptible
slices, flaky data pipelines, bf16 overflow) needs the failure paths to be
*testable*, so this module provides the chaos harness the resilience
machinery is validated against:

- **Injection points** are named call sites threaded through the stack
  (see ``POINTS``).  A disabled point costs one module-attribute read at
  the call site (``_active`` is False unless a spec is installed), so the
  eager dispatch hot path stays at pre-fault-framework cost.
- **Specs** arm points deterministically: by call count (``at=N``, the
  point's Nth probe fires) or by seeded probability (``prob=0.3``),
  optionally bounded (``times=K``).  Spec syntax (also via the
  ``MXNET_FAULT_SPEC`` env alias of the ``fault.spec`` config knob)::

      point:key=val,key=val[;point2:...]
      e.g.  dataloader.worker_crash:at=2
            invoke.nan_output:prob=0.05,seed=7,times=1

- **Events** count both injected faults and the recovery actions they
  provoke (worker respawns, skipped non-finite steps, checkpoint
  rejections...).  ``stats()`` returns the table; ``log_stats()`` emits
  it through ``mx.log`` so chaos tests and operators see exactly what
  fired and what recovered.

Spawned DataLoader worker processes re-import this module and re-read
``MXNET_FAULT_SPEC`` from their inherited environment, so worker-side
points (``dataloader.worker_crash``/``worker_hang``) arm in the worker
while parent-side state stays untouched.
"""
from __future__ import annotations

import random as _pyrandom
import threading

from . import config as _config
from . import telemetry as _telemetry
from .base import MXNetError

__all__ = ["POINTS", "configure", "clear", "active", "armed", "fire",
           "record", "stats", "reset_stats", "log_stats", "describe"]

#: every injection point threaded through the stack -> what arming it proves
POINTS = {
    "dataloader.worker_crash":
        "a multiprocess DataLoader worker dies mid-task (os._exit): the "
        "loader respawns the pool with backoff, bounded by "
        "dataloader.max_respawns, then degrades to threaded workers",
    "dataloader.worker_hang":
        "a worker stops producing (sleeps past the loader timeout): the "
        "heartbeat deadline treats it as dead and the respawn path runs",
    "pipeline.prefetch_stall":
        "a DevicePrefetcher's background thread wedges between batches "
        "(probed at the top of its loop, holding neither the source nor a "
        "batch): the consumer's stall deadline fires, a replacement "
        "thread takes over the same source iterator, and batch order is "
        "preserved",
    "invoke.nan_output":
        "an eager op returns all-NaN: the Trainer non-finite guard "
        "(trainer.skip_nonfinite) skips the step and counts it",
    "kvstore.collective_timeout":
        "a blocking dist collective never completes: the watchdog raises "
        "a structured CollectiveTimeout instead of hanging",
    "serialization.torn_write":
        "a checkpoint's bytes are silently truncated on disk: checksum "
        "validation rejects it and auto-resume picks the previous one",
    "resilience.preempt":
        "the cluster preempts this worker (SIGTERM analog, probed once "
        "per step): the in-flight step finishes, the TrainState bundle "
        "is written, and training stops with the resume sentinel",
    "autotune.trial_oom":
        "a measured autotune trial exhausts device memory (probed once "
        "per trial, before its step compiles): the candidate is recorded "
        "as oom in autotune.* telemetry and the search continues to the "
        "next grid point",
    "fleet.host_loss":
        "a peer host vanishes mid-run (its heartbeat lease expires with "
        "no clean exit; probed once per step): the fleet supervisor "
        "re-plans the mesh over the surviving devices, restores the "
        "last valid bundle bitwise, and continues at a smaller dp",
    "fleet.slow_host":
        "a host falls past fleet.slow_fraction of the step deadline but "
        "keeps making progress (probed once per step): the watchdog "
        "marks it a straggler (fleet.stragglers gauge) without killing "
        "it — slow, not wedged",
    "fleet.lease_lost":
        "this host's own heartbeat lease cannot be renewed "
        "(coordination service or lease dir unreachable): renewals are "
        "counted as failures, /healthz turns red, and the heartbeat "
        "keeps retrying",
    "blackbox.torn_bundle":
        "the host dies mid-write of a postmortem bundle (the just-"
        "written blackbox-<rank>-<step>.json is truncated after its "
        "checksum landed): verify_checksum rejects it, latest_bundle "
        "and tools/postmortem.py skip it, and the fleet merge proceeds "
        "on the surviving bundles",
    "stream.torn_record":
        "one streamed record's payload is corrupted in flight (probed "
        "per record read, before checksum verification): the per-record "
        "crc32 rejects it and stream.on_corrupt picks the path — 'skip' "
        "drops it with stream.records_skipped_total, 'raise' escalates "
        "a structured CorruptRecord the blackbox recorder carries into "
        "the postmortem bundle",
    "stream.shard_unreadable":
        "a shard archive cannot be opened (probed once per open "
        "attempt): bounded retry-with-backoff (stream.open_retries / "
        "stream.open_backoff) counts stream.open_retries_total, and "
        "exhausting the budget escalates a WorkerLost-style "
        "ShardUnreadable — a structured failure, never a hang",
    "serve.replica_crash":
        "a serving replica's host dies mid-stream (probed once per "
        "fleet supervisor tick): the mx.servefleet router marks the "
        "replica dead, its KV slots are gone, and every incomplete "
        "request re-dispatches to a survivor under its idempotency "
        "key, re-prefilling from the original prompt — no accepted "
        "request is dropped or double-completed",
    "serve.replica_stall":
        "a serving replica's step loop wedges while its lease stays "
        "fresh (probed once per fleet supervisor tick): after "
        "servefleet.stall_deadline without decode progress the "
        "supervisor declares it dead, re-dispatches its requests, and "
        "then drains the already-dispatched device work — any late "
        "completion racing the re-dispatch is suppressed by the "
        "idempotency ledger",
    "serve.prefix_evict":
        "a hot cached prefix is force-evicted from the radix index "
        "between a request's admission-time match and the KV row copy "
        "(probed once per prefix-cache hit): the engine falls back to "
        "a full prefill of the whole prompt — the output stays token-"
        "for-token identical, only the reuse saving is lost, counted "
        "in serve.prefix_misses_total",
    "insight.drift":
        "one observed step-time sample is stretched 3x (probed at "
        "every insight drift-feed sample): the EWMA+MAD detector must "
        "raise an insight.drift event within insight.drift_window "
        "samples, count insight.drift_events_total, and flip the "
        "/healthz insight provider to degraded",
}

_lock = threading.Lock()
_specs: dict[str, "_Spec"] = {}
_stats: dict[str, int] = {}
#: hot-path gate — call sites read this one attribute when deciding
#: whether to probe; False keeps every hook a no-op branch
_active = False


class _Spec:
    """One armed point: fires by call count and/or seeded probability."""

    __slots__ = ("point", "prob", "at", "times", "fired", "calls", "_rng")

    def __init__(self, point, prob=None, at=None, times=None, seed=0):
        self.point = point
        self.prob = prob
        self.at = at
        self.times = times
        self.fired = 0
        self.calls = 0
        # per-point stream: reproducible regardless of arming order
        self._rng = _pyrandom.Random(hash((point, seed)) & 0xFFFFFFFF)

    def probe(self, step=None):
        """Decide one probe.  ``step`` overrides the point's own call
        counter with an externally-maintained sequence number — the
        DataLoader passes its global task sequence so ``at=N`` stays
        deterministic across worker processes and pool respawns."""
        self.calls += 1
        if self.times is not None and self.fired >= self.times:
            return False
        hit = False
        if self.at is not None:
            hit = (step if step is not None else self.calls) == self.at
        if not hit and self.prob is not None:
            hit = self._rng.random() < self.prob
        if hit:
            self.fired += 1
        return hit


def _parse(spec_str):
    """``point:k=v,k=v;point2:...`` -> {point: _Spec}."""
    specs = {}
    for part in filter(None, (p.strip() for p in spec_str.split(";"))):
        point, _, argstr = part.partition(":")
        point = point.strip()
        if point not in POINTS:
            raise MXNetError(
                f"unknown fault injection point {point!r}; known: "
                f"{sorted(POINTS)}")
        kwargs = {}
        for item in filter(None, (a.strip() for a in argstr.split(","))):
            key, _, val = item.partition("=")
            key = {"p": "prob", "at_step": "at", "max": "times"}.get(key, key)
            if key == "prob":
                kwargs["prob"] = float(val)
            elif key in ("at", "times", "seed"):
                kwargs[key] = int(val)
            else:
                raise MXNetError(
                    f"fault spec {part!r}: unknown key {key!r} "
                    "(use prob=, at=, times=, seed=)")
        if "prob" not in kwargs and "at" not in kwargs:
            raise MXNetError(
                f"fault spec {part!r} needs a trigger: prob= or at=")
        specs[point] = _Spec(point, **kwargs)
    return specs


def configure(spec=None):
    """Install a fault spec (string, or None to re-read the ``fault.spec``
    config knob / ``MXNET_FAULT_SPEC`` env).  Replaces any previous spec."""
    global _active
    if spec is None:
        spec = _config.get("fault.spec") or ""
    with _lock:
        _specs.clear()
        _specs.update(_parse(spec) if spec else {})
        _active = bool(_specs)
    from . import _hooks
    _hooks.refresh()
    return sorted(_specs)


def clear():
    """Disarm every point (stats are kept; see ``reset_stats``)."""
    global _active
    with _lock:
        _specs.clear()
        _active = False
    from . import _hooks
    _hooks.refresh()


def active():
    """True when any point is armed (the hot-path gate)."""
    return _active


def armed(point):
    """True when this specific point is armed — lets recovery paths that
    normally only exist multi-process (e.g. the dist watchdog) engage for
    single-process chaos tests."""
    return _active and point in _specs


def fire(point, step=None):
    """Probe an armed point.  Returns True when the fault should happen
    now; counts both the probe and the injection.  ``step`` substitutes
    an external sequence number for the point's own call counter (see
    ``_Spec.probe``)."""
    if not _active:
        return False
    spec = _specs.get(point)
    if spec is None:
        return False
    with _lock:
        hit = spec.probe(step)
    if hit:
        record("injected." + point)
    return hit


def record(event, n=1):
    """Count a fault or recovery event (recovery code calls this even when
    injection is off — real faults are counted identically).  Every event
    also mirrors into ``mx.telemetry`` (``fault.events_total{event=...}``)
    when the metrics registry is enabled, so run reports and the
    Prometheus exposition carry the resilience picture."""
    with _lock:
        _stats[event] = _stats.get(event, 0) + n
    if _telemetry._active:
        _telemetry.inc("fault.events_total", n, event=event)


def stats():
    """Snapshot of every counter: ``injected.<point>`` plus recovery
    events (``dataloader.worker_respawn``, ``trainer.nonfinite_skip``,
    ``checkpoint.rejected``, ...)."""
    with _lock:
        return dict(sorted(_stats.items()))


def reset_stats():
    with _lock:
        _stats.clear()


def describe():
    """Human-readable table of points and any armed spec."""
    lines = []
    for point in sorted(POINTS):
        spec = _specs.get(point)
        state = "off"
        if spec is not None:
            parts = []
            if spec.at is not None:
                parts.append(f"at={spec.at}")
            if spec.prob is not None:
                parts.append(f"prob={spec.prob}")
            if spec.times is not None:
                parts.append(f"times={spec.times}")
            state = ",".join(parts) + f" (fired {spec.fired}/{spec.calls})"
        lines.append(f"{point} [{state}]: {POINTS[point]}")
    return "\n".join(lines)


def log_stats(level=None):
    """Emit the stats table through ``mx.log`` (chaos tests assert on the
    counters via ``stats()``; operators read this)."""
    from . import log as _log
    logger = _log.get_logger("mxnet_tpu_torch.fault")
    snap = stats()
    if not snap:
        logger.info("fault: no events recorded")
        return snap
    width = max(map(len, snap))
    table = "\n".join(f"  {k:<{width}} {v}" for k, v in snap.items())
    logger.log(level if level is not None else _log.INFO,
               "fault event counters:\n%s", table)
    return snap


# arm from the environment at import so spawned DataLoader workers (which
# re-import the package) inherit the spec without any explicit handshake
if _config.get("fault.spec"):
    configure()
