"""mx.telemetry — framework-wide always-on metrics + training run reports.

Port of ``mxnet_tpu/telemetry.py``: the same registry, catalog,
recompilation detector, event ring, readers, ops endpoint and
``TrainingTelemetry``, with three differences. ``record_memory`` reads
``torch.cuda.memory_stats`` (live ``allocated_bytes.all.current``, peak
``allocated_bytes.all.peak``) and the card's size
(``torch.cuda.mem_get_info``), host-side, with no synchronization; with no
card it returns ``{}``, as the reference does on the CPU. ``/servefleet``
answers as the reference does while no servefleet runs (``servefleet`` is
not ported yet). Run reports carry no autotune or static-analysis plane:
those modules are not ported yet, and the reference leaves both out while
they hold nothing. A "compile" of a hybridized block or a serve bucket is
a CUDA-graph capture here (on the CPU: the first call of a signature).

Reference parity: the reference's engine-integrated profiler
(src/profiler/profiler.h) answers "where did the time go?" per op; it has
no always-on layer answering "why is this RUN slow or flaky?".  On a
compiler-backed TPU stack the dominant production pathologies are
invisible to a span profiler: XLA recompilation storms from
shape-polymorphic hybridized blocks, dataloader stalls, collective
latency, and steps silently skipped by the resilience layer
(docs/FAULT_TOLERANCE.md).  This module is the metrics plane for those:

- **Registry**: process-wide counters, gauges and bucketed histograms,
  lock-protected, optionally labelled (low-cardinality labels only —
  block names, collective ops, fault event names).
- **Near-zero disabled cost**: mirroring ``fault.py``, every
  instrumentation site in the stack gates on one module-attribute read
  (``_active``); with telemetry off (the default) a hook is a single
  ``if`` on a False attribute.  The CI ``telemetry`` stage enforces the
  <2% overhead budget on a tight eager-op loop
  (benchmark/telemetry_overhead.py).
- **Wired subsystems**: cached-graph compile/cache-hit accounting +
  recompilation detector (gluon/block.py), dataloader batch wait / queue
  depth / respawns (gluon/data/dataloader.py), trainer step time /
  grad-norm / non-finite skips (gluon/trainer.py), per-collective latency
  and payload bytes (kvstore/dist.py), and every ``mx.fault`` event
  (injections and recoveries mirror into ``fault.events_total``).
- **Recompilation detector**: one hybridized block re-tracing more than
  ``telemetry.recompile_limit`` times is the classic TPU
  shape-polymorphism pitfall (a new XLA compile per input signature); the
  detector emits one structured :class:`RecompileWarning` per block,
  carrying the block name and compile count.
- **Reporters**: ``exposition()`` renders a Prometheus-style text dump;
  :class:`TrainingTelemetry` emits periodic JSONL step records and a
  final structured run report, and bridges emitted records into
  ``mx.profiler`` events when the profiler runs.  ``profiler.set_state
  ("run")`` auto-enables telemetry, so one switch captures everything.

Enable via ``mx.telemetry.enable()`` or the ``MXNET_TELEMETRY`` env alias
of the ``telemetry.enable`` config knob (read at import, like
``MXNET_FAULT_SPEC``).
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import threading
import time

from . import config as _config
from .base import MXNetError

__all__ = ["enable", "disable", "configure", "active", "inc", "set_gauge",
           "observe", "timed", "declare_metric", "note_compile", "counters",
           "summary_line", "snapshot", "exposition", "serve_http",
           "stop_http", "reset", "RecompileWarning", "TrainingTelemetry",
           "CATALOG", "EXPOSITION_CONTENT_TYPE", "register_health",
           "unregister_health", "health", "note_event", "events"]

_lock = threading.Lock()
#: hot-path gate — instrumentation sites read this one attribute; False
#: keeps every hook a single no-op branch (same design as fault._active)
_active = False

_counters: dict[tuple[str, tuple], float] = {}
_gauges: dict[tuple[str, tuple], float] = {}
_hists: dict[tuple[str, tuple], "_Hist"] = {}

# -- metric catalog ---------------------------------------------------------

#: seconds-scale latencies (compile, step, batch wait, collectives)
TIME_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                float("inf"))
#: wide-dynamic-range magnitudes (gradient norms)
MAGNITUDE_BUCKETS = tuple(10.0 ** e for e in range(-4, 7)) + (float("inf"),)

_Kind = str  # "counter" | "gauge" | "histogram"
CATALOG: dict[str, tuple[_Kind, str, tuple | None]] = {}


def declare_metric(name, kind, doc, buckets=None):
    """Register a metric in the catalog (drives exposition() HELP/TYPE
    lines and docs/OBSERVABILITY.md's table).  Undeclared names are
    auto-registered on first use with a generic doc."""
    if kind not in ("counter", "gauge", "histogram"):
        raise MXNetError(f"unknown metric kind {kind!r}")
    with _lock:
        CATALOG.setdefault(name, (kind, doc,
                                  tuple(buckets) if buckets else None))
    return name


declare_metric("invoke.ops_total", "counter",
               "eager ops dispatched through _invoke")
declare_metric("cached_graph.compile_total", "counter",
               "captures of hybridized blocks (CUDA graphs; the first call of a "
               "signature on the CPU), by block class")
declare_metric("cached_graph.compile_seconds", "histogram",
               "wall time of one hybridized capture (warm-up run included)",
               buckets=TIME_BUCKETS)
declare_metric("cached_graph.cache_hit_total", "counter",
               "compiled-forward replays served from the signature cache")
declare_metric("cached_graph.cache_miss_total", "counter",
               "calls whose signature required a fresh capture")
declare_metric("cached_graph.signatures", "gauge",
               "live signatures in a block's executable cache")
declare_metric("cached_graph.recompile_warnings_total", "counter",
               "blocks flagged by the recompilation detector")
declare_metric("dataloader.wait_seconds", "histogram",
               "time the training loop blocked waiting for the next batch",
               buckets=TIME_BUCKETS)
declare_metric("dataloader.queue_depth", "gauge",
               "in-flight prefetch tasks when the loop asked for a batch")
declare_metric("dataloader.batches_total", "counter",
               "batches produced by worker-backed loaders")
declare_metric("dataloader.respawn_total", "counter",
               "worker-pool respawns after a crash or missed heartbeat")
declare_metric("dataloader.shm_created_total", "counter",
               "SharedMemory segments created by process workers")
declare_metric("dataloader.shm_reused_total", "counter",
               "batch leaves served from the shm reuse pool instead of a "
               "fresh segment")
declare_metric("trainer.step_seconds", "histogram",
               "wall time of Trainer.step (allreduce + update)",
               buckets=TIME_BUCKETS)
declare_metric("trainer.steps_total", "counter",
               "optimizer steps applied")
declare_metric("trainer.grad_norm", "histogram",
               "global gradient L2 norm per step (finite steps only)",
               buckets=MAGNITUDE_BUCKETS)
declare_metric("trainer.nonfinite_total", "counter",
               "steps skipped by the non-finite gradient guard")
declare_metric("kvstore.collective_seconds", "histogram",
               "latency of one cross-process collective, by op",
               buckets=TIME_BUCKETS)
declare_metric("kvstore.collective_total", "counter",
               "cross-process collectives issued, by op")
declare_metric("kvstore.payload_bytes_total", "counter",
               "bytes moved through cross-process collectives, by op")
declare_metric("kvstore.collective_errors_total", "counter",
               "cross-process collectives that failed (timeout or fabric "
               "error), by op — disjoint from collective_total, which "
               "counts successes only")
declare_metric("resilience.collective_retry_total", "counter",
               "collective attempts retried after a transient failure, "
               "by op")
declare_metric("resilience.rejoin_total", "counter",
               "successful pre-retry coordination-service re-barriers")
declare_metric("resilience.rejoin_failed_total", "counter",
               "best-effort re-barriers that timed out (peer gone or "
               "still inside the collective)")
declare_metric("resilience.worker_lost_raised_total", "counter",
               "collective retry budgets exhausted -> WorkerLost raised")
declare_metric("resilience.bundle_save_total", "counter",
               "TrainState bundles written")
declare_metric("resilience.bundle_restore_total", "counter",
               "TrainState bundles restored")
declare_metric("resilience.preempt_signal_total", "counter",
               "preemption signals observed, by signal")
declare_metric("resilience.restart_total", "counter",
               "supervised train-fn restarts after WorkerLost")
declare_metric("resilience.restart_budget_reset_total", "counter",
               "restart budgets reset after a healthy-progress window "
               "(resilience.restart_window_steps) between WorkerLost "
               "events")
declare_metric("resilience.bundle_gc_total", "counter",
               "TrainState bundle generations deleted by retention GC "
               "(torn, or older than resilience.keep_bundles)")
declare_metric("fault.events_total", "counter",
               "mx.fault injections and recovery events, by event")
declare_metric("train.iter_seconds", "histogram",
               "full training-loop iteration time (TrainingTelemetry.step)",
               buckets=TIME_BUCKETS)
declare_metric("telemetry.records_total", "counter",
               "JSONL records emitted by TrainingTelemetry")
declare_metric("telemetry.events_total", "counter",
               "python warnings and framework log records captured into "
               "the bounded telemetry event ring, by kind")
declare_metric("telemetry.report_rotations_total", "counter",
               "TrainingTelemetry JSONL files rolled to a .gNNNN "
               "generation by the telemetry.report_max_bytes cap")
declare_metric("memory.bytes_in_use", "gauge",
               "per-device live bytes (torch.cuda.memory_stats), by device")
declare_metric("memory.peak_bytes_in_use", "gauge",
               "per-device peak allocated bytes since start, by device")
declare_metric("memory.bytes_limit", "gauge",
               "per-device memory capacity (torch.cuda.mem_get_info), by device")
declare_metric("autotune.candidates_total", "counter",
               "config-search grid points considered by mx.autotune")
declare_metric("autotune.pruned_total", "counter",
               "candidates the analytic cost model rejected without a "
               "compile, by reason (dominated/hbm/invalid/vmem/"
               "ranked_out)")
declare_metric("autotune.trials_total", "counter",
               "measured autotune trials executed (compile + short "
               "timed window), including failed ones")
declare_metric("autotune.trials_oom_total", "counter",
               "autotune trials that died of device OOM (recorded, "
               "search continues)")
declare_metric("autotune.trials_parity_total", "counter",
               "fp8 autotune trials rejected by the loss-parity probe "
               "(relative delta vs the fp32 reference beyond "
               "autotune.fp8_parity_tol; search continues)")
declare_metric("autotune.search_seconds", "histogram",
               "wall time of one full autotune search",
               buckets=TIME_BUCKETS)
declare_metric("autotune.best_speedup", "gauge",
               "measured items/s of the autotune winner over the "
               "untuned default config")
declare_metric("telemetry.scrape_duration_seconds", "gauge",
               "wall time the ops endpoint spent rendering the last "
               "/metrics exposition")
declare_metric("autotune.cache_hits_total", "counter",
               "searches answered from the persisted winners file "
               "(fingerprint match, zero trials re-run)")
declare_metric("autotune.kernel_trials_total", "counter",
               "measured kernel-level block-shape trials executed by "
               "mx.autotune.kernels (including failed ones)")
declare_metric("autotune.kernel_cache_hits_total", "counter",
               "kernel block-shape searches answered from the persisted "
               "winners file (bucket match, zero trials re-run)")
declare_metric("autotune.retunes_total", "counter",
               "drift-triggered kernel re-tunes applied at a checkpoint "
               "boundary (Retuner hot-swaps)")
declare_metric("autotune.learned_rank_corr", "gauge",
               "Spearman rank correlation of the learned kernel cost "
               "model against measured trials at the last rank gate")


# -- switches ---------------------------------------------------------------

def enable(on=True):
    """Turn the registry on/off.  Off (the default) every instrumentation
    hook in the stack is one module-attribute read.  Enabling also arms
    the pipeline sync-site counter so ``snapshot()["sync_sites"]`` and
    ``pipeline.host_syncs_total`` report where host syncs happen."""
    global _active
    _active = bool(on)
    from . import pipeline as _pipeline   # lazy: pipeline imports us
    _pipeline.arm_site_counts("telemetry", _active)
    from . import _hooks
    _hooks.refresh()
    return _active


def disable():
    enable(False)


def configure():
    """Re-read the ``telemetry.enable`` config knob / ``MXNET_TELEMETRY``
    env alias."""
    return enable(_config.get("telemetry.enable"))


def active():
    return _active


# -- recording --------------------------------------------------------------

def _labels_key(labels):
    return tuple(sorted(labels.items()))


def _auto_register(name, kind):
    existing = CATALOG.get(name)
    if existing is None:
        CATALOG[name] = (kind, "(auto-registered)", None)
    elif existing[0] != kind:
        raise MXNetError(
            f"metric {name!r} is a {existing[0]}, not a {kind}")
    return CATALOG[name]


def inc(name, n=1, **labels):
    """Add ``n`` to a counter (no-op while disabled)."""
    if not _active:
        return
    key = (name, _labels_key(labels))
    with _lock:
        _auto_register(name, "counter")
        _counters[key] = _counters.get(key, 0) + n


def set_gauge(name, value, **labels):
    """Set a gauge to ``value`` (no-op while disabled)."""
    if not _active:
        return
    key = (name, _labels_key(labels))
    with _lock:
        _auto_register(name, "gauge")
        _gauges[key] = value


class _Hist:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value):
        self.counts[bisect.bisect_left(self.buckets, value)] += 1
        self.sum += value
        self.count += 1


#: raw-sample listeners (mx.insight's drift feed, mx.goodput's ledger
#: feed): histogram name -> {tag: callable}, each callable receiving
#: every observed value.  Consulted only while the registry is enabled,
#: after the bucket update and OUTSIDE _lock, so a listener may record
#: metrics of its own.
_sample_listeners: dict[str, dict] = {}


def add_sample_listener(name, fn, tag="default"):
    """Register ``fn(value)`` to receive every raw :func:`observe`
    sample for histogram ``name``.  Listeners are keyed by ``tag`` so
    independent planes (insight's drift detector, goodput's ledger)
    coexist on one histogram; re-registering a tag replaces it."""
    _sample_listeners.setdefault(name, {})[tag] = fn


def remove_sample_listener(name, tag="default"):
    fns = _sample_listeners.get(name)
    if fns is not None:
        fns.pop(tag, None)
        if not fns:
            _sample_listeners.pop(name, None)


def observe(name, value, **labels):
    """Record one sample into a bucketed histogram (no-op while
    disabled).  Buckets come from the catalog declaration; undeclared
    histograms get TIME_BUCKETS."""
    if not _active:
        return
    key = (name, _labels_key(labels))
    with _lock:
        spec = _auto_register(name, "histogram")
        h = _hists.get(key)
        if h is None:
            h = _hists[key] = _Hist(spec[2] or TIME_BUCKETS)
        h.observe(value)
    fns = _sample_listeners.get(name)
    if fns is not None:
        for fn in tuple(fns.values()):
            fn(value)


@contextlib.contextmanager
def timed(name, **labels):
    """Context manager observing its wall time into histogram ``name``;
    free when disabled."""
    if not _active:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        observe(name, time.perf_counter() - t0, **labels)


def record_memory(devices=None):
    """Refresh the ``memory.*`` gauges from ``torch.cuda.memory_stats``
    and return ``{device_index: {live, peak, limit}}`` (bytes): live is
    ``allocated_bytes.all.current``, peak ``allocated_bytes.all.peak``
    (since start or the last ``reset_peak_memory_stats``), limit the
    card's total memory (``torch.cuda.mem_get_info``).

    Called at the step loop's drain points (``Trainer.drain_telemetry``,
    ``TrainingTelemetry`` run reports) so live/peak memory is observable
    without per-step host syncs: the allocator's counters are host state,
    and reading them synchronizes nothing.  Without a card it yields an
    empty dict — a cheap no-op, so callers don't need to gate on
    platform.  No-op while the registry is disabled.
    """
    if not _active:
        return {}
    import torch
    if devices is None:
        if not torch.cuda.is_available():
            return {}
        devices = range(torch.cuda.device_count())
    out = {}
    for d in devices:
        d = torch.device("cuda", d) if isinstance(d, int) else \
            torch.device(d)
        if d.type != "cuda":
            continue
        stats = torch.cuda.memory_stats(d)
        dev = str(d.index if d.index is not None
                  else torch.cuda.current_device())
        live = int(stats.get("allocated_bytes.all.current", 0))
        peak = int(stats.get("allocated_bytes.all.peak", 0))
        limit = int(torch.cuda.mem_get_info(d)[1])
        set_gauge("memory.bytes_in_use", live, device=dev)
        set_gauge("memory.peak_bytes_in_use", peak, device=dev)
        set_gauge("memory.bytes_limit", limit, device=dev)
        out[dev] = {"live": live, "peak": peak, "limit": limit}
    return out


def reset():
    """Drop every recorded value (the catalog and enabled state stay)."""
    global _events
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
    with _events_lock:
        _events = None
    from . import pipeline as _pipeline   # lazy: pipeline imports us
    _pipeline.reset_site_counts()


# -- bounded event ring -----------------------------------------------------

#: bounded ring of structured events — python warnings (RecompileWarning
#: et al.) and framework log records >= WARNING — fed by the capture
#: hooks mx.blackbox installs; postmortem bundles embed it so a crash
#: carries the warnings that preceded it, not just metric totals.
_events = None
_events_lock = threading.Lock()


def note_event(kind, message, **fields):
    """Append one structured event to the bounded ring (capacity from
    the ``telemetry.event_ring`` knob; oldest dropped first).  Unlike the
    metric recorders this does not gate on ``_active`` — the installers
    (mx.blackbox's warning/log capture hooks) are the gate, so an armed
    recorder never loses the event that explains a crash."""
    global _events
    import collections
    entry = {"kind": kind, "message": str(message)[:2048],
             "time": time.time(), **fields}
    with _events_lock:
        if _events is None:
            _events = collections.deque(
                maxlen=max(1, int(_config.get("telemetry.event_ring"))))
        _events.append(entry)
    inc("telemetry.events_total", kind=kind)
    return entry


def events(last=None):
    """Captured ring events, oldest first (``last`` = newest N only)."""
    with _events_lock:
        out = list(_events) if _events is not None else []
    if last is not None:
        out = out[-int(last):]
    return out


# -- recompilation detector -------------------------------------------------

class RecompileWarning(UserWarning):
    """One hybridized block keeps capturing: the shape-polymorphism
    pitfall (every new input shape/dtype signature costs a fresh warm-up
    and CUDA-graph capture).  Structured: ``block`` (class name), ``compiles`` (count so
    far), ``limit`` (the tripped threshold)."""

    def __init__(self, block, compiles, limit):
        self.block = block
        self.compiles = compiles
        self.limit = limit
        super().__init__(
            f"hybridized block {block!r} recompiled {compiles} times "
            f"(telemetry.recompile_limit={limit}): each distinct input "
            "shape/dtype signature triggers a fresh capture. "
            "Pad or bucket input shapes (drop_last/fixed seq-len), or "
            "raise the limit if the signature set is genuinely bounded.")


def note_compile(owner, label, seconds, signatures=None):
    """Account one capture of a hybridized block (or a serve bucket).

    ``owner`` is the Block instance — the per-block compile count and the
    warn-once latch live on it, so the detector fires exactly once per
    block no matter how many _CachedGraphs (train/eval) it owns.
    """
    if not _active:
        return
    inc("cached_graph.compile_total", block=label)
    observe("cached_graph.compile_seconds", seconds, block=label)
    if signatures is not None:
        set_gauge("cached_graph.signatures", signatures, block=label)
    limit = _config.get("telemetry.recompile_limit")
    with _lock:
        n = owner.__dict__.get("_telemetry_compiles", 0) + 1
        owner.__dict__["_telemetry_compiles"] = n
        fire = (n > limit
                and not owner.__dict__.get("_telemetry_recompile_warned"))
        if fire:
            owner.__dict__["_telemetry_recompile_warned"] = True
    if fire:
        inc("cached_graph.recompile_warnings_total")
        import warnings
        from . import log as _log
        w = RecompileWarning(label, n, limit)
        warnings.warn(w, stacklevel=2)
        _log.get_logger("mxnet_tpu_torch.telemetry").warning("%s", w)


# -- readers ----------------------------------------------------------------

def _render(name, labels, extra=()):
    items = list(labels) + list(extra)
    if not items:
        return name
    return name + "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


def _le(bound):
    return "+Inf" if bound == float("inf") else repr(float(bound))


_QUANTILES = (0.5, 0.95, 0.99)


def _hist_quantiles(h, qs=_QUANTILES):
    """Estimate quantiles from bucket counts by linear interpolation
    inside the containing bucket (the Prometheus histogram_quantile
    rule): the first bucket interpolates from 0, and a quantile landing
    in the +Inf bucket degrades to the highest finite bound — an
    estimate, exact only at bucket edges, but monotone and cheap.
    Returns {q: value}; empty histograms return {}."""
    if h.count == 0:
        return {}
    out = {}
    finite_hi = 0.0
    for bound, c in zip(h.buckets, h.counts):
        if bound != float("inf") and c:
            finite_hi = bound
    for q in qs:
        target = q * h.count
        acc = 0
        lo = 0.0
        val = finite_hi
        for bound, c in zip(h.buckets, h.counts):
            if acc + c >= target and c:
                if bound == float("inf"):
                    val = lo if lo else finite_hi
                else:
                    val = lo + (bound - lo) * (target - acc) / c
                break
            acc += c
            if bound != float("inf"):
                lo = bound
        out[q] = val
    return out


def quantiles(name, qs=_QUANTILES, **labels):
    """Estimated quantiles of one recorded histogram as
    {"p50": v, "p95": v, ...} (None when nothing was recorded).  Serving
    SLOs (serve.ttft/tpot) and the latency histograms (dataloader.
    batch_wait, kvstore.*) read their percentiles through this."""
    key = (name, _labels_key(labels))
    with _lock:
        h = _hists.get(key)
        if h is None or h.count == 0:
            return None
        est = _hist_quantiles(h, qs)
    return {f"p{('%g' % (100 * q)).replace('.', '_')}": v
            for q, v in est.items()}


def counters(prefix=None, aggregate=False):
    """Flat dict of counters.  ``aggregate=True`` sums away labels (one
    value per metric name) — what LoggingHandler's epoch summary pulls."""
    out = {}
    with _lock:
        for (name, labels), v in _counters.items():
            if prefix and not name.startswith(prefix):
                continue
            if aggregate:
                out[name] = out.get(name, 0) + v
            else:
                out[_render(name, labels)] = v
    return dict(sorted(out.items()))


def summary_line():
    """One-line 'k=v k=v' digest of every counter (labels aggregated) for
    log lines; '' when nothing was recorded."""
    snap = counters(aggregate=True)
    if not snap:
        return ""
    return " ".join(f"{k}={v:g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in snap.items())


def snapshot():
    """JSON-safe snapshot of every metric: counters/gauges as rendered
    name -> value, histograms as {buckets(le->cumulative), sum, count}."""
    with _lock:
        counter_snap = {_render(n, ls): v for (n, ls), v in _counters.items()}
        gauge_snap = {_render(n, ls): v for (n, ls), v in _gauges.items()}
        hist_snap = {}
        for (n, ls), h in _hists.items():
            cum, acc = {}, 0
            for bound, c in zip(h.buckets, h.counts):
                acc += c
                cum[_le(bound)] = acc
            hist_snap[_render(n, ls)] = {
                "buckets": cum, "sum": h.sum, "count": h.count,
                "quantiles": {("%g" % (100 * q)): v for q, v in
                              _hist_quantiles(h).items()}}
    from . import pipeline as _pipeline   # lazy: pipeline imports us
    return {"counters": dict(sorted(counter_snap.items())),
            "gauges": dict(sorted(gauge_snap.items())),
            "histograms": dict(sorted(hist_snap.items())),
            "sync_sites": _pipeline.sync_site_counts()}


def _sanitize(name):
    return "mxnet_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def exposition():
    """Prometheus-style text exposition of every recorded metric (HELP/
    TYPE from the catalog)."""
    with _lock:
        by_name: dict[str, list] = {}
        for (n, ls), v in _counters.items():
            by_name.setdefault(n, []).append((ls, v))
        for (n, ls), v in _gauges.items():
            by_name.setdefault(n, []).append((ls, v))
        for (n, ls), h in _hists.items():
            by_name.setdefault(n, []).append((ls, h))
        catalog = dict(CATALOG)
    lines = []
    order = [n for n in catalog if n in by_name] + \
        sorted(n for n in by_name if n not in catalog)
    for name in order:
        kind, doc, _ = catalog.get(name, ("counter", "(auto)", None))
        full = _sanitize(name)
        lines.append(f"# HELP {full} {doc}")
        lines.append(f"# TYPE {full} {kind}")
        for labels, v in sorted(by_name[name]):
            if isinstance(v, _Hist):
                acc = 0
                for bound, c in zip(v.buckets, v.counts):
                    acc += c
                    le = _render("", labels, (("le", _le(bound)),))
                    lines.append(f"{full}_bucket{le} {acc}")
                lines.append(f"{full}_sum{_render('', labels)} {v.sum:g}")
                lines.append(f"{full}_count{_render('', labels)} {v.count}")
                for q, qv in _hist_quantiles(v).items():
                    ql = _render("", labels, (("quantile", "%g" % q),))
                    lines.append(f"{full}{ql} {qv:g}")
            else:
                vv = f"{v:g}" if isinstance(v, float) else str(v)
                lines.append(f"{full}{_render('', labels)} {vv}")
    return "\n".join(lines) + ("\n" if lines else "")


# -- stdlib ops endpoint ----------------------------------------------------

#: the Prometheus text-format content type scrapers key parsing on
EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_http_server = None

#: liveness providers consulted by /healthz: name -> zero-arg callable
#: returning a bool or a dict with an "ok" key. The fleet health plane
#: and the serve engine register here so the endpoint reflects step-loop
#: and lease liveness instead of a static OK.
_health_providers: dict[str, object] = {}


def register_health(name, provider):
    """Register a liveness check under ``name`` (replaces a previous
    one).  ``provider()`` -> bool or {"ok": bool, ...detail}; any check
    that is falsy (or raises) turns /healthz red (HTTP 503)."""
    with _lock:
        _health_providers[name] = provider
    return name


def unregister_health(name):
    with _lock:
        _health_providers.pop(name, None)


def health():
    """Aggregate every registered liveness check.  Returns
    ``(ok, checks)`` where checks is {name: {"ok": bool, ...}}."""
    with _lock:
        providers = dict(_health_providers)
    ok, checks = True, {}
    for name, fn in sorted(providers.items()):
        try:
            res = fn()
        except Exception as e:   # noqa: BLE001 - a dead check is a red check
            res = {"ok": False, "error": str(e)}
        if not isinstance(res, dict):
            res = {"ok": bool(res)}
        res.setdefault("ok", True)
        checks[name] = res
        ok = ok and bool(res["ok"])
    return ok, checks


def serve_http(port=None):
    """Start the in-process ops endpoint (stdlib ``http.server``, daemon
    thread) — the surface a fleet scrapes:

    - ``GET /metrics``  — :func:`exposition` with the proper
      ``Content-Type: text/plain; version=0.0.4`` header; each scrape
      sets the ``telemetry.scrape_duration_seconds`` gauge.
    - ``GET /healthz``  — liveness JSON (pid, telemetry/trace state).
    - ``GET /trace?last=N&category=C`` — the newest N ``mx.trace``
      spans as JSON, optionally filtered to one category.
    - ``GET /insight``  — the mx.insight attribution report (local +
      merged fleet view) as JSON.
    - ``GET /goodput``  — the mx.goodput ledger (local bucket waterfall
      + capacity-weighted fleet device-second merge) as JSON.
    - ``GET /servefleet`` — the mx.servefleet control-plane view (per-
      replica states, generations, ledger counters) as JSON.
    - ``GET /postmortem?last=N`` — metadata of the newest N mx.blackbox
      postmortem bundles in the resolved bundle directory.

    ``port=None`` reads the ``telemetry.http_port`` knob
    (``MXNET_TELEMETRY_PORT``); 0 binds an ephemeral port — read it back
    from ``server.server_address[1]``.  Idempotent: a running server is
    returned as-is; ``stop_http()`` shuts it down."""
    global _http_server
    if _http_server is not None:
        return _http_server
    import http.server
    import urllib.parse

    class _OpsHandler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *args):  # keep scrapes out of stderr
            pass

        def _send(self, code, body, ctype):
            data = body.encode("utf-8") if isinstance(body, str) else body
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 - http.server API
            url = urllib.parse.urlsplit(self.path)
            if url.path == "/metrics":
                t0 = time.perf_counter()
                exposition()
                set_gauge("telemetry.scrape_duration_seconds",
                          time.perf_counter() - t0)
                # render again so the gauge is visible in THIS scrape
                body = exposition()
                from . import insight as _insight
                if _insight._active:
                    try:
                        # host-labelled fleet series merged from the
                        # lease-dir snapshots (mx.insight fleet view)
                        body += _insight.fleet_exposition()
                    except Exception:   # noqa: BLE001
                        pass            # a torn snapshot can't 500 a scrape
                self._send(200, body, EXPOSITION_CONTENT_TYPE)
            elif url.path == "/healthz":
                from . import trace as _trace
                ok, checks = health()
                self._send(200 if ok else 503, json.dumps(
                    {"status": "ok" if ok else "unhealthy",
                     "pid": os.getpid(),
                     "telemetry_active": _active,
                     "trace": _trace.stats(),
                     "checks": checks}), "application/json")
            elif url.path == "/trace":
                from . import trace as _trace
                query = urllib.parse.parse_qs(url.query)
                last = None
                if "last" in query:
                    try:
                        last = int(query["last"][0])
                    except ValueError:
                        self._send(400, json.dumps(
                            {"error": "last must be an integer"}),
                            "application/json")
                        return
                category = query["category"][0] \
                    if "category" in query else None
                self._send(200, json.dumps(
                    {"spans": _trace.spans(last, category=category),
                     "dropped": _trace.stats()["dropped"]}),
                    "application/json")
            elif url.path == "/insight":
                from . import insight as _insight
                self._send(200, json.dumps(_insight.endpoint_report()),
                           "application/json")
            elif url.path == "/goodput":
                from . import goodput as _goodput
                self._send(200, json.dumps(_goodput.endpoint_report()),
                           "application/json")
            elif url.path == "/servefleet":
                # what the reference's servefleet answers while no fleet
                # group runs (servefleet is not ported yet)
                self._send(200, json.dumps({"active": False, "fleets": []}),
                           "application/json")
            elif url.path == "/postmortem":
                from . import blackbox as _blackbox
                query = urllib.parse.parse_qs(url.query)
                last = None
                if "last" in query:
                    try:
                        last = int(query["last"][0])
                    except ValueError:
                        self._send(400, json.dumps(
                            {"error": "last must be an integer"}),
                            "application/json")
                        return
                self._send(200, json.dumps(
                    _blackbox.endpoint_report(last)), "application/json")
            else:
                self._send(404, json.dumps(
                    {"error": f"unknown path {url.path!r}",
                     "paths": ["/metrics", "/healthz", "/insight",
                               "/goodput", "/servefleet",
                               "/trace?last=N&category=C",
                               "/postmortem?last=N"]}),
                    "application/json")

    if port is None:
        port = int(_config.get("telemetry.http_port"))
    server = http.server.ThreadingHTTPServer(("127.0.0.1", port),
                                             _OpsHandler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever,
                     name="mx-telemetry-http", daemon=True).start()
    _http_server = server
    return server


def stop_http():
    """Shut the ops endpoint down (no-op when not running)."""
    global _http_server
    server, _http_server = _http_server, None
    if server is not None:
        server.shutdown()
        server.server_close()


# -- structured training run reports ---------------------------------------

def _analyze_summary():
    """The static-analysis plane for run reports: None, what the
    reference's ``_analyze_summary`` returns while its analyzer holds
    nothing (``analyze/`` is not ported yet)."""
    return None


class TrainingTelemetry:
    """Structured training-run reporter over the registry.

    - ``step()`` once per training iteration: observes iteration time and
      every ``interval`` steps emits one JSONL record (cumulative counters
      + caller fields).  When ``mx.profiler`` is running each emitted
      record also lands as a profiler event, so one trace holds spans AND
      run metrics.
    - ``mark()`` emits an ad-hoc record (epoch boundaries etc.).
    - ``close()`` emits and returns the final run report: step count,
      wall time, and the full metric snapshot (histograms included) —
      the machine-readable answer to "what did this run do?".

    ``path=None`` keeps records in memory only (``.records``); a path
    appends JSONL lines (one json object per line; ``read()`` parses them
    back).  Constructing a reporter enables the registry; ``close()``
    restores the previous enabled state.
    """

    def __init__(self, path=None, interval=None, run_id=None):
        self._path = path if path is not None \
            else (_config.get("telemetry.jsonl") or None)
        self._interval = max(1, int(
            interval if interval is not None
            else _config.get("telemetry.step_interval")))
        self.run_id = run_id or f"run-{os.getpid()}"
        self.records = []
        self._file = None
        self._steps = 0
        self._t0 = time.time()
        self._last = time.perf_counter()
        self._closed = False
        self._was_active = _active
        enable()
        self._emit({"type": "run_begin", "run_id": self.run_id,
                    "time": self._t0, "pid": os.getpid()})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _emit(self, record):
        inc("telemetry.records_total")
        self.records.append(record)
        if self._path:
            line = json.dumps(record) + "\n"
            if self._file is None:
                self._file = open(self._path, "a")
            limit = int(_config.get("telemetry.report_max_bytes") or 0)
            if limit > 0 and self._file.tell() \
                    and self._file.tell() + len(line) > limit:
                self._rotate()
            self._file.write(line)
            self._file.flush()
        from . import profiler as _profiler
        if _profiler.is_running():
            _profiler.record_event(
                f"telemetry.{record['type']}", "telemetry",
                time.perf_counter_ns() // 1000, 0,
                {k: v for k, v in record.items()
                 if isinstance(v, (int, float, str))})

    def _rotate(self):
        """Roll the JSONL file to the next free ``<path>.gNNNN``
        generation and reopen fresh.  The size cap is checked before a
        record is written, so rotation never truncates mid-record, and
        rotated generations stay on disk — :meth:`generations` finds
        them (ROADMAP item 5 trains on these files)."""
        self._file.close()
        self._file = None
        n = 0
        while os.path.exists(f"{self._path}.g{n:04d}"):
            n += 1
        os.replace(self._path, f"{self._path}.g{n:04d}")
        inc("telemetry.report_rotations_total")
        self._file = open(self._path, "a")

    def step(self, step=None, **fields):
        """Record one training iteration; emit a JSONL step record every
        ``interval`` calls.  ``fields`` (loss, lr, ...) ride along."""
        self._steps += 1
        now = time.perf_counter()
        iter_s = now - self._last
        self._last = now
        observe("train.iter_seconds", iter_s)
        n = self._steps if step is None else step
        if self._steps % self._interval == 0:
            self._emit({"type": "step", "run_id": self.run_id, "step": n,
                        "time": time.time(), "iter_seconds": iter_s,
                        **fields, "counters": counters()})

    def mark(self, kind, **fields):
        """Emit an ad-hoc record (e.g. ``mark("epoch", epoch=3)``)."""
        self._emit({"type": kind, "run_id": self.run_id,
                    "time": time.time(), **fields})

    def report(self):
        """The final run report dict (also what ``close()`` emits)."""
        out = {"type": "run_report", "run_id": self.run_id,
               "steps": self._steps,
               "wall_seconds": time.time() - self._t0,
               "memory": record_memory(),
               "metrics": snapshot()}
        # the autotune plane is not ported yet: the reference leaves it
        # out while it holds nothing
        linted = _analyze_summary()
        if linted is not None:
            out["analyze"] = linted
        from . import insight as _insight
        observed = _insight.last_summary()
        if observed is not None:
            out["insight"] = observed
        from . import goodput as _goodput
        ledger = _goodput.last_summary()
        if ledger is not None:
            out["goodput"] = ledger
        return out

    def close(self):
        """Emit the run report, close the JSONL file, restore the
        registry's previous enabled state; returns the report."""
        if self._closed:
            return self._report
        self._report = self.report()
        self._emit(self._report)
        self._closed = True
        if self._file is not None:
            self._file.close()
            self._file = None
        enable(self._was_active)
        return self._report

    @staticmethod
    def read(path):
        """Parse a JSONL file written by a reporter -> list of records."""
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    @staticmethod
    def generations(path):
        """Every surviving generation of a rotated report, oldest first
        (``<path>.g0000``, ``<path>.g0001``, ..., then the live file).
        Rotation renames, never deletes — this is the discovery surface
        for consumers of the full run history."""
        import glob
        gens = sorted(glob.glob(glob.escape(path) + ".g[0-9]*"))
        if os.path.exists(path):
            gens.append(path)
        return gens


# arm from the environment at import (MXNET_TELEMETRY=1), mirroring
# fault.py, so spawned workers and plain scripts inherit the switch
if _config.get("telemetry.enable"):
    enable()

# MXNET_TELEMETRY_PORT=N arms the ops endpoint at import (best-effort:
# a taken port must not kill the training job it observes)
if _config.get("telemetry.http_port"):
    try:
        serve_http()
    except OSError:
        pass
