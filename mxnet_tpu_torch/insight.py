"""mx.insight — live performance attribution, fleet-wide metric
aggregation, and step-time drift detection.

Three planes (docs/OBSERVABILITY.md "Performance attribution, fleet
view & drift"):

- **Attribution** — every compiled surface (``ShardedTrainStep``, gluon
  ``_CachedGraph``, serve decode/prefill buckets, autotune trials)
  registers its cost (flops / bytes accessed / output bytes) plus
  argument signatures at capture time, so measured step time turns into a live ``insight.mfu`` gauge and a
  compute-vs-memory roofline verdict per executable — the bench.py
  accounting, on every run instead of only in the bench grid.
- **Fleet view** — each host periodically snapshots its telemetry +
  insight state as an atomic JSON file next to the mx.fleet heartbeat
  leases; the ops endpoint merges them so ``/metrics`` carries
  host-labelled fleet series and ``/insight`` returns the merged
  attribution report.
- **Drift** — a rolling robust baseline (median/MAD anchor + winsorised
  EWMA; ``insight.drift_window`` / ``insight.drift_sigma`` knobs) over
  the raw ``trainer.step_seconds`` / ``serve.step_seconds`` samples and
  the sharded train-step loop.  Sustained slowdown emits
  ``insight.drift`` events (telemetry counter + trace span + fault-plane
  record), turns the ``/healthz`` ``insight`` provider red, and feeds
  mx.fleet a per-host relative-slowness straggler signal.

Cost discipline matches telemetry/trace/fault: disabled (the default),
every hook is one module-attribute read.

Port of ``mxnet_tpu/insight.py``. Where the reference reads XLA's
``cost_analysis()``, the port counts the cost of a captured graph or a
serve bucket once, on the warm-up run before its capture (:func:`count`):
FLOPs by ``torch.utils.flop_counter``'s formulas over the aten ops a
dispatch mode sees (``FlopCounterMode``'s count), plus the FLOPs each
hand-written kernel's wrapper adds for itself while a count runs (:func:`add_flops`: the flash-attention forward
4·b·h·pairs·d, its dK/dV 8· and dQ 6·, pairs the visible (q, k) pairs,
halved when causal; the low-bit GEMMs 2·M·N·K; kernel 8 2·9·N·H·W·C·O for
each of dgrad and wgrad), and bytes as the executable's inputs' (its
parameters among them) and outputs' bytes. A counted executable exposes
the result through its own ``cost_analysis()``, so :func:`capture_cost`
reads both. The peaks are the H100's published rates (``PEAK_FLOPS``,
``PEAK_BYTES_PER_S``, keyed by a substring of
``torch.cuda.get_device_name()``), beside the reference's nominal ``cpu``
row; the device kind and argument signatures come from torch.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import threading
import time

from . import config as _config
from . import fault as _fault
from . import telemetry as _telemetry
from . import trace as _trace

__all__ = [
    "enable", "disable", "configure", "active", "reset",
    "capture_cost", "capture_jit", "register_executable", "note_step",
    "roofline_verdict", "input_stall_p50", "attribution", "last_summary",
    "healthz",
    "drift_events", "DriftDetector", "on_drift", "remove_drift_hook",
    "write_snapshot", "maybe_snapshot", "read_snapshots",
    "merge_snapshots", "fleet_exposition", "relative_slowness",
    "endpoint_report",
]

_telemetry.declare_metric(
    "insight.mfu", "gauge",
    "Measured model-flops utilisation per registered executable: "
    "counted flops over the last measured step time, divided by "
    "the chip's peak FLOP/s.")
_telemetry.declare_metric(
    "insight.executables", "gauge",
    "Compiled executables currently held in the attribution registry.")
_telemetry.declare_metric(
    "insight.drift_events_total", "counter",
    "Step-time drift events raised by the EWMA+MAD detector, by "
    "source.")
_telemetry.declare_metric(
    "insight.degraded_sources", "gauge",
    "Drift sources currently past threshold (sustained slowdown); "
    "nonzero flips the /healthz insight provider red.")
_telemetry.declare_metric(
    "insight.snapshots_written_total", "counter",
    "Fleet insight snapshots atomically published next to the "
    "heartbeat leases.")
_telemetry.declare_metric(
    "insight.fleet_snapshot_age_seconds", "gauge",
    "Age of each host's merged fleet snapshot at scrape time, by "
    "host — the staleness signal for the fleet view.")

#: peak FLOP/s by a lower-case substring of the card's name
#: (``torch.cuda.get_device_name``): the H100's published dense bf16 rate
#: (NVIDIA's data sheet, SXM, 700 W), plus the reference's nominal
#: host-CPU entry so a CPU run still reports a defined — if approximate —
#: MFU.
PEAK_FLOPS = {
    "h100": 989e12,
    "cpu": 1e11,
}

#: memory bandwidth (bytes/s) by the same substring (the H100's 3.35 TB/s
#: of HBM3) — the roofline's machine-balance denominator.
PEAK_BYTES_PER_S = {
    "h100": 3.35e12,
    "cpu": 5e10,
}

_lock = threading.Lock()
_active = False

#: attribution registry: executable name -> entry dict
_exes: dict[str, dict] = {}
#: drift detectors: source name -> DriftDetector
_detectors: dict[str, "DriftDetector"] = {}
#: recent drift events, oldest first (bounded)
_drift_ring: list[dict] = []
_DRIFT_RING_CAP = 256
#: per-executable previous note_step() wall clock (inter-arrival timing)
_last_call: dict[str, float] = {}
_snap_last = 0.0
_peak_cache = None


# -- switches ----------------------------------------------------------------

def active():
    return _active


def _trainer_samples(value):
    _feed("trainer.step", value)


def _serve_samples(value):
    _feed("serve.step", value, exe="serve.decode")


def enable(on=True):
    """Flip the insight plane.  Enabling registers the ``insight``
    /healthz provider and the raw-sample listeners on the step-time
    histograms the drift detector rides (``trainer.step_seconds`` /
    ``serve.step_seconds``)."""
    global _active
    _active = bool(on)
    if _active:
        _telemetry.register_health("insight", healthz)
        _telemetry.add_sample_listener("trainer.step_seconds",
                                       _trainer_samples, tag="insight")
        _telemetry.add_sample_listener("serve.step_seconds",
                                       _serve_samples, tag="insight")
    else:
        _telemetry.unregister_health("insight")
        _telemetry.remove_sample_listener("trainer.step_seconds",
                                          tag="insight")
        _telemetry.remove_sample_listener("serve.step_seconds",
                                          tag="insight")
    return _active


def disable():
    return enable(False)


def configure():
    """Re-arm from the knob/environment state (MXNET_INSIGHT)."""
    return enable(bool(_config.get("insight.enable")))


def reset():
    """Drop every registered executable, detector, drift event and
    snapshot timer (the enabled state stays)."""
    global _snap_last, _peak_cache
    with _lock:
        _exes.clear()
        _detectors.clear()
        _drift_ring.clear()
        _last_call.clear()
        _drift_hooks.clear()
        _snap_last = 0.0
        _peak_cache = None


# -- device peaks & roofline -------------------------------------------------

def _device_kind():
    import torch
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(0).lower()


def _lookup_peaks(kind):
    for sub, peak in PEAK_FLOPS.items():
        if sub != "cpu" and sub in kind:
            return peak, PEAK_BYTES_PER_S[sub]
    return PEAK_FLOPS["cpu"], PEAK_BYTES_PER_S["cpu"]


def _peaks(kind=None):
    """(peak FLOP/s, peak bytes/s) for ``kind`` (default: this process's
    first device, cached)."""
    global _peak_cache
    if kind is not None:
        return _lookup_peaks(str(kind).lower())
    if _peak_cache is None:
        _peak_cache = _lookup_peaks(_device_kind())
    return _peak_cache


def input_stall_p50():
    """Median recorded ``pipeline.input_stall_seconds`` (the device-
    prefetch consumer's wait for the host producer), or None without
    samples — the signal that separates a slow step from a starved
    one."""
    q = _telemetry.quantiles("pipeline.input_stall_seconds")
    return q.get("p50") if q else None


def roofline_verdict(flops, bytes_accessed, peak_flops=None,
                     peak_bytes_per_s=None, step_seconds=None):
    """``'input'`` | ``'compute'`` | ``'memory'`` | None.

    With ``step_seconds`` (a measured wall-clock step time), input
    starvation is tested first: when the recorded
    ``pipeline.input_stall_seconds`` p50 exceeds
    ``insight.input_bound_ratio`` × the step time the verdict is
    ``'input'`` regardless of arithmetic intensity — starvation
    masquerades as compute cost (arxiv 2008.01040), so the data plane
    must be ruled out before the roofline is read.  Otherwise:
    arithmetic intensity (flops/byte) against the machine balance (peak
    FLOP/s over peak bytes/s) — the classic roofline ridge-point
    test."""
    if step_seconds:
        stall = input_stall_p50()
        if stall is not None and stall > (
                float(_config.get("insight.input_bound_ratio"))
                * float(step_seconds)):
            return "input"
    if not flops or not bytes_accessed:
        return None
    if peak_flops is None or peak_bytes_per_s is None:
        pf, pb = _peaks()
        peak_flops = peak_flops or pf
        peak_bytes_per_s = peak_bytes_per_s or pb
    balance = peak_flops / peak_bytes_per_s
    return "compute" if flops / bytes_accessed >= balance else "memory"


# -- cost capture ------------------------------------------------------------

#: hot-path gate of :func:`add_flops`: the number of counts running
_counting = 0
#: the running counts' kernel FLOPs, process-wide: autograd runs a CUDA
#: backward (the flash dK/dV and dQ kernels) on its own device thread
_count_stack: list = []


def add_flops(flops):
    """Add a hand-written kernel's FLOPs to every running count (a
    dispatch mode does not see a kernel launched through its C
    interface). Wrappers call it where they launch, gated on
    ``_counting``."""
    with _lock:
        for c in _count_stack:
            c[0] += flops


def _flop_mode():
    """A dispatch mode that sums ``torch.utils.flop_counter``'s formulas
    over the aten ops it sees: ``FlopCounterMode``'s count without its
    module tracker, whose backward hooks ``torch.autograd.grad`` of leaf
    tensors refuses (a capture's warm-up takes such gradients)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _FlopMode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            return out
    return _FlopMode()


def _tensor_bytes(tree):
    from torch.utils import _pytree as pytree
    import torch
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@contextlib.contextmanager
def count(inputs=()):
    """Count the cost of the run inside the scope: yields a dict that is
    filled on exit with ``flops`` (aten ops by the formulas of
    ``torch.utils.flop_counter``, the backward that autograd runs inside
    the scope included, plus :func:`add_flops`) and ``bytes_accessed`` (the bytes of ``inputs``
    plus those of the outputs set as ``cost["outputs"]`` inside the scope,
    which is then dropped)."""
    global _counting
    cost = {}
    extra = [0]
    mode = _flop_mode()
    with _lock:
        _count_stack.append(extra)
        _counting += 1
    try:
        with mode:
            yield cost
    finally:
        with _lock:
            _count_stack.remove(extra)
            _counting -= 1
    outputs = cost.pop("outputs", ())
    cost["flops"] = float(mode.flops + extra[0])
    cost["bytes_accessed"] = float(_tensor_bytes(inputs)
                                   + _tensor_bytes(outputs))
    cost["output_bytes"] = float(_tensor_bytes(outputs))


def capture_cost(compiled_or_lowered):
    """Normalise XLA ``cost_analysis()`` into ``{"flops",
    "bytes_accessed", "output_bytes"}`` (floats; keys present only when
    the backend reports them).  Accepts both ``Lowered`` (HLO-level
    analysis, no backend compile) and ``Compiled`` objects, unwraps the
    per-device list some backends return, and never raises —
    attribution is strictly best-effort."""
    try:
        ca = compiled_or_lowered.cost_analysis()
    except Exception:   # noqa: BLE001 - backends without analysis
        return {}
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else None
    if not isinstance(ca, dict):
        return {}
    out = {}
    flops = ca.get("flops")
    if flops is not None and float(flops) > 0:
        out["flops"] = float(flops)
    nbytes = ca.get("bytes accessed")
    if nbytes is not None and float(nbytes) > 0:
        out["bytes_accessed"] = float(nbytes)
    # the Lowered-level analysis names output traffic 'bytes accessedout{}'
    obytes = ca.get("bytes accessedout{}")
    if obytes is not None:
        out["output_bytes"] = float(obytes)
    return out


def _signature(args, kwargs=None, limit=16):
    """Compact ``'float32[8,16]'``-style signatures for the argument
    pytree leaves (non-array leaves skipped), capped at ``limit``."""
    if args is None:
        return []
    from torch.utils import _pytree as pytree
    leaves = pytree.tree_leaves((args, kwargs or {}))
    out = []
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is None or dtype is None:
            continue
        if len(out) >= limit:
            out.append(f"...({len(leaves)} leaves total)")
            break
        dims = ",".join(str(d) for d in shape)
        out.append(f"{getattr(dtype, 'name', dtype)}[{dims}]")
    return out


def register_executable(name, compiled=None, args=None, kwargs=None,
                        cost=None, kind=None):
    """Register one compiled surface in the attribution registry.

    An explicit ``cost`` (a :func:`capture_cost` dict) wins; otherwise
    it is captured from ``compiled``.  Returns the registry entry, or
    None while the plane is disabled."""
    if not _active:
        return None
    if cost is None:
        cost = capture_cost(compiled) if compiled is not None else {}
    entry = {
        "name": name,
        "kind": kind or name.split(".", 1)[0],
        "flops": cost.get("flops"),
        "bytes_accessed": cost.get("bytes_accessed"),
        "output_bytes": cost.get("output_bytes"),
        "args": _signature(args, kwargs),
        "bound": roofline_verdict(cost.get("flops"),
                                  cost.get("bytes_accessed")),
        "steps": 0,
        "seconds_total": 0.0,
        "last_seconds": None,
        "achieved_flops_per_s": None,
        "mfu": None,
        "registered_at": time.time(),
    }
    with _lock:
        _exes[name] = entry
        n = len(_exes)
    if _telemetry._active:
        _telemetry.set_gauge("insight.executables", n)
    return entry


def capture_jit(name, compiled, args, kind=None, **kwargs):
    """Register a captured graph by the cost counted on its warm-up run
    (its ``cost_analysis()``): no second run and no
    ``telemetry.note_compile``, so the recompile detector and compile
    counters are untouched (the reference re-lowers a ``jax.jit``)."""
    if not _active:
        return None
    return register_executable(name, compiled=compiled, args=args,
                               kwargs=kwargs, kind=kind)


# -- drift detection ---------------------------------------------------------

class DriftDetector:
    """Rolling robust step-time drift detector.

    The first full ``window`` samples anchor a robust baseline (their
    median) and scale (MAD, floored at 1% of the baseline so noise-free
    series keep a usable band).  Every later sample folds into an EWMA
    (``alpha = 2/(window+1)``) after being winsorised at
    ``ewma + 8*scale`` — a single spike cannot drag the average — and
    drift fires on the rising edge once the EWMA sits more than
    ``sigma * scale`` above baseline for two consecutive samples.
    One-sided by design: speedups never alarm, and ``degraded`` clears
    itself when the EWMA decays back under threshold."""

    def __init__(self, source, window=None, sigma=None):
        self.source = source
        self.window = max(4, int(
            window if window is not None
            else _config.get("insight.drift_window")))
        self.sigma = float(sigma if sigma is not None
                           else _config.get("insight.drift_sigma"))
        self.alpha = 2.0 / (self.window + 1.0)
        self.baseline = None
        self.scale = None
        self.ewma = None
        self.degraded = False
        self.events = 0
        self.count = 0
        self._anchor: list[float] = []
        self._over = 0

    def update(self, value):
        """Fold one sample in; True exactly when a drift event fires."""
        value = float(value)
        self.count += 1
        if self.baseline is None:
            self._anchor.append(value)
            if len(self._anchor) >= self.window:
                med = statistics.median(self._anchor)
                mad = statistics.median(
                    abs(x - med) for x in self._anchor)
                self.baseline = med
                self.scale = max(1.4826 * mad, 0.01 * abs(med), 1e-12)
                self.ewma = med
                self._anchor = []
            return False
        clipped = min(value, self.ewma + 8.0 * self.scale)
        self.ewma += self.alpha * (clipped - self.ewma)
        if self.ewma - self.baseline > self.sigma * self.scale:
            self._over += 1
            if not self.degraded and self._over >= 2:
                self.degraded = True
                self.events += 1
                return True
        else:
            self._over = 0
            self.degraded = False
        return False

    def state(self):
        return {"source": self.source, "window": self.window,
                "sigma": self.sigma, "count": self.count,
                "baseline": self.baseline, "scale": self.scale,
                "ewma": self.ewma, "degraded": self.degraded,
                "events": self.events}


def note_step(name, seconds=None, step=None):
    """Record one measured execution of registered executable ``name``.

    ``seconds=None`` derives the sample from the interval since the
    previous ``note_step(name)`` — steady-state loop time measured on
    wall clocks the caller already pays, adding no device syncs."""
    if not _active:
        return
    now = time.perf_counter()
    with _lock:
        prev = _last_call.get(name)
        _last_call[name] = now
    if seconds is None:
        if prev is None:
            return
        seconds = now - prev
    _feed(name, seconds, exe=name, step=step)


def _feed(source, seconds, exe=None, step=None):
    """One raw step-time sample: apply the ``insight.drift`` chaos point
    (an injected 3x stretch), update the executable's measured stats and
    ``insight.mfu``, then run the source's drift detector."""
    seconds = float(seconds)
    if _fault._active and _fault.fire("insight.drift", step=step):
        seconds *= 3.0
    peak_flops = _peaks()[0]
    fired = False
    event = None
    mfu = None
    exe_name = None
    with _lock:
        entry = _exes.get(exe) if exe is not None else None
        if entry is not None and seconds > 0:
            entry["steps"] += 1
            entry["seconds_total"] += seconds
            entry["last_seconds"] = seconds
            flops = entry.get("flops")
            if flops:
                achieved = flops / seconds
                entry["achieved_flops_per_s"] = achieved
                mfu = entry["mfu"] = achieved / peak_flops
                exe_name = entry["name"]
        det = _detectors.get(source)
        if det is None:
            det = _detectors[source] = DriftDetector(source)
        fired = det.update(seconds)
        degraded = sum(1 for d in _detectors.values() if d.degraded)
        if fired:
            event = {"source": source, "seconds": seconds,
                     "baseline": det.baseline, "ewma": det.ewma,
                     "scale": det.scale, "sigma": det.sigma,
                     "count": det.count, "time": time.time()}
            if step is not None:
                event["step"] = int(step)
            _drift_ring.append(event)
            del _drift_ring[:-_DRIFT_RING_CAP]
    if _telemetry._active:
        if mfu is not None:
            _telemetry.set_gauge("insight.mfu", round(mfu, 6),
                                 executable=exe_name)
        _telemetry.set_gauge("insight.degraded_sources", degraded)
    if fired:
        _record_drift(source, event)


#: external drift subscribers (e.g. the autotune Retuner arming an
#: online kernel re-search) — called as fn(source, event), exceptions
#: swallowed: a broken subscriber must not take the drift plane down
_drift_hooks: list = []


def on_drift(fn):
    """Subscribe ``fn(source, event)`` to every drift event; returns
    ``fn`` (decorator-friendly).  Idempotent per function object."""
    if fn not in _drift_hooks:
        _drift_hooks.append(fn)
    return fn


def remove_drift_hook(fn):
    """Unsubscribe; unknown functions are a no-op."""
    try:
        _drift_hooks.remove(fn)
    except ValueError:
        pass


def _record_drift(source, event):
    """Mirror one drift event into the telemetry, fault and trace
    planes, then fan out to the registered drift hooks."""
    if _telemetry._active:
        _telemetry.inc("insight.drift_events_total", source=source)
    _fault.record("insight.drift")
    if _trace._active:
        from . import profiler as _profiler
        _trace.emit("insight.drift", _profiler.now_us(), 0,
                    category="insight", source=source,
                    seconds=round(event["seconds"], 6),
                    baseline=round(event["baseline"], 6),
                    ewma=round(event["ewma"], 6))
    from . import blackbox as _blackbox
    if _blackbox._active:
        # a sustained slowdown is a terminal-class anomaly: freeze the
        # evidence window now, while the degraded state is still live
        _blackbox.dump(trigger="drift",
                       reason=f"insight.drift: {source}",
                       step=event.get("step"))
    for fn in list(_drift_hooks):
        try:
            fn(source, event)
        except Exception:
            pass


def drift_events():
    """Recent drift events, oldest first (bounded ring)."""
    with _lock:
        return list(_drift_ring)


def healthz():
    """The /healthz ``insight`` provider: red while any drift source is
    degraded (sustained slowdown past the EWMA+MAD threshold)."""
    with _lock:
        degraded = sorted(s for s, d in _detectors.items() if d.degraded)
        sources = len(_detectors)
        exes = len(_exes)
        events = sum(d.events for d in _detectors.values())
    return {"ok": not degraded, "degraded": degraded, "sources": sources,
            "executables": exes, "drift_events": events}


# -- reports -----------------------------------------------------------------

def attribution():
    """The live attribution report: per-executable cost + measured MFU +
    roofline verdict, drift-detector states, recent drift events."""
    pf, pb = _peaks()
    with _lock:
        exes = {n: dict(e) for n, e in _exes.items()}
        drift = {s: d.state() for s, d in _detectors.items()}
        events = list(_drift_ring)
    # re-read each verdict against the MEASURED step time: a registry
    # entry's static compute/memory call flips to 'input' when the
    # recorded input-stall p50 dominates the step it feeds
    stall = input_stall_p50()
    if stall is not None:
        for e in exes.values():
            if e.get("last_seconds"):
                v = roofline_verdict(e.get("flops"),
                                     e.get("bytes_accessed"),
                                     step_seconds=e["last_seconds"])
                if v == "input":
                    e["bound"] = "input"
    return {"device_kind": _device_kind(),
            "peak_flops_per_s": pf, "peak_bytes_per_s": pb,
            "machine_balance_flops_per_byte": pf / pb,
            "input_stall_p50_s": stall,
            "executables": exes, "drift": drift, "drift_events": events}


def last_summary():
    """The ``insight`` plane for TrainingTelemetry run reports (same
    contract as autotune/analyze planes); None when nothing was
    recorded."""
    with _lock:
        empty = not _exes and not _detectors and not _drift_ring
    if empty:
        return None
    return attribution()


def endpoint_report(lease_dir=None):
    """The ``/insight`` ops-endpoint body: local attribution plus the
    merged fleet view when lease-dir snapshots exist."""
    out = {"enabled": _active, "local": attribution()}
    try:
        out["fleet"] = merge_snapshots(lease_dir)
    except Exception:   # noqa: BLE001 - a torn snapshot can't 500 the scrape
        out["fleet"] = None
    return out


# -- fleet snapshots & merge -------------------------------------------------

SNAPSHOT_PREFIX = "insight-"


def _snapshot_path(lease_dir, rank):
    return os.path.join(lease_dir, f"{SNAPSHOT_PREFIX}{int(rank)}.json")


def write_snapshot(lease_dir=None, rank=0):
    """Atomically publish this host's telemetry + insight state as
    ``insight-<rank>.json`` next to the heartbeat leases (the
    HealthPlane tmp + ``os.replace`` idiom, so readers never see a torn
    file).  Returns the path, or None without a lease dir."""
    lease_dir = lease_dir or _config.get("fleet.lease_dir")
    if not lease_dir:
        return None
    snap = _telemetry.snapshot()
    payload = {"rank": int(rank), "pid": os.getpid(), "time": time.time(),
               "counters": snap["counters"], "gauges": snap["gauges"],
               "insight": attribution()}
    os.makedirs(lease_dir, exist_ok=True)
    path = _snapshot_path(lease_dir, rank)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(json.dumps(payload))
    os.replace(tmp, path)
    if _telemetry._active:
        _telemetry.inc("insight.snapshots_written_total")
    return path


def maybe_snapshot(lease_dir=None, rank=0, interval=None):
    """Rate-limited :func:`write_snapshot` — the fleet heartbeat hook
    (rides ``HealthPlane.beat``, so snapshot cadence needs no thread of
    its own)."""
    global _snap_last
    if not _active:
        return None
    if interval is None:
        interval = float(_config.get("insight.snapshot_interval"))
    now = time.monotonic()
    with _lock:
        if _snap_last and now - _snap_last < interval:
            return None
        _snap_last = now
    try:
        return write_snapshot(lease_dir, rank)
    except OSError:
        return None


def read_snapshots(lease_dir=None):
    """{rank: payload} for every well-formed ``insight-*.json`` snapshot
    in the lease dir (torn/foreign files skipped)."""
    lease_dir = lease_dir or _config.get("fleet.lease_dir")
    out = {}
    if not lease_dir or not os.path.isdir(lease_dir):
        return out
    for fname in sorted(os.listdir(lease_dir)):
        if not (fname.startswith(SNAPSHOT_PREFIX)
                and fname.endswith(".json")):
            continue
        try:
            with open(os.path.join(lease_dir, fname)) as f:
                payload = json.loads(f.read())
            out[int(payload["rank"])] = payload
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return out


def merge_snapshots(lease_dir=None):
    """Merge every host snapshot into the fleet view: counters summed,
    gauges maxed (both also kept per host), executables unioned (the
    slowest host's measurement wins the headline — that host bounds the
    fleet's step time), drift sources degraded when ANY host is.
    Refreshes the per-host ``insight.fleet_snapshot_age_seconds``
    staleness gauge.  None when no snapshots exist."""
    snaps = read_snapshots(lease_dir)
    if not snaps:
        return None
    now = time.time()
    merged = {"hosts": sorted(snaps), "time": now,
              "snapshot_age_seconds": {}, "counters": {}, "gauges": {},
              "per_host": {}, "executables": {}, "drift": {},
              "drift_events": []}
    for rank in sorted(snaps):
        p = snaps[rank]
        age = max(0.0, now - float(p.get("time", 0.0)))
        merged["snapshot_age_seconds"][str(rank)] = round(age, 3)
        if _telemetry._active:
            _telemetry.set_gauge("insight.fleet_snapshot_age_seconds",
                                 round(age, 3), host=str(rank))
        counters = dict(p.get("counters") or {})
        gauges = dict(p.get("gauges") or {})
        merged["per_host"][str(rank)] = {"counters": counters,
                                         "gauges": gauges}
        for k, v in counters.items():
            merged["counters"][k] = merged["counters"].get(k, 0) + v
        for k, v in gauges.items():
            prev = merged["gauges"].get(k)
            try:
                merged["gauges"][k] = v if prev is None else max(prev, v)
            except TypeError:
                merged["gauges"][k] = v
        ins = p.get("insight") or {}
        for name, e in (ins.get("executables") or {}).items():
            cur = merged["executables"].get(name)
            pick = dict(e)
            if cur is not None and (cur.get("last_seconds") or 0) >= \
                    (e.get("last_seconds") or 0):
                pick = dict(cur)
            pick["hosts"] = ((cur or {}).get("hosts") or []) + [rank]
            merged["executables"][name] = pick
        for src, d in (ins.get("drift") or {}).items():
            cur = merged["drift"].setdefault(
                src, {"degraded": False, "events": 0, "per_host": {}})
            cur["degraded"] = cur["degraded"] or bool(d.get("degraded"))
            cur["events"] += int(d.get("events") or 0)
            cur["per_host"][str(rank)] = d
        for ev in (ins.get("drift_events") or []):
            merged["drift_events"].append({**ev, "host": rank})
    merged["drift_events"].sort(key=lambda e: e.get("time", 0.0))
    # per-axis collective traffic rollup: parse the labeled
    # mesh.collective_bytes_total{axis="dp"} / zero.collective_bytes_total
    # {op=...} samples out of the summed counters so the fleet view
    # answers "how many bytes moved per mesh axis" (and makes the
    # compression cut directly observable: the dp sample counts wire
    # bytes at the compressed width vs mesh.dp_gradient_bytes_total's
    # uncompressed payload)
    coll = {"by_axis": {}, "zero_by_op": {}}
    for k, v in merged["counters"].items():
        m = re.match(r'mesh\.collective_bytes_total\{axis="([^"]+)"\}$', k)
        if m:
            ax = m.group(1)
            coll["by_axis"][ax] = coll["by_axis"].get(ax, 0) + v
            continue
        m = re.match(r'zero\.collective_bytes_total\{op="([^"]+)"\}$', k)
        if m:
            op = m.group(1)
            coll["zero_by_op"][op] = coll["zero_by_op"].get(op, 0) + v
    comp = merged["counters"].get("comm.compressed_bytes_total", 0)
    uncomp = merged["counters"].get("comm.uncompressed_bytes_total", 0)
    if uncomp and comp:
        coll["compression_ratio"] = round(uncomp / comp, 3)
    if coll["by_axis"] or coll["zero_by_op"]:
        merged["collectives"] = coll
    return merged


def _prom_sample(rendered, value, host):
    """One Prometheus sample line from a snapshot's rendered
    ``name{labels}`` key, with a ``host`` label spliced in."""
    try:
        vv = f"{float(value):g}"
    except (TypeError, ValueError):
        return None
    name, _, rest = rendered.partition("{")
    labels = [f'host="{host}"']
    if rest:
        labels.append(rest[:-1])
    return f"{_telemetry._sanitize(name)}{{{','.join(labels)}}} {vv}"


def fleet_exposition(lease_dir=None):
    """Prometheus text for the fleet view, appended to ``/metrics`` by
    the scraped host: every snapshot counter/gauge re-rendered with a
    ``host="<rank>"`` label, fleet-wide sums (counters) and maxes
    (gauges) under ``host="fleet"``, and the per-host snapshot-age
    staleness gauge.  '' when no snapshots exist."""
    merged = merge_snapshots(lease_dir)
    if merged is None:
        return ""
    lines = ["# fleet view (mx.insight): host-labelled series merged "
             "from lease-dir snapshots"]

    def _extend(kv, host):
        for k, v in sorted(kv.items()):
            line = _prom_sample(k, v, host)
            if line is not None:
                lines.append(line)

    for rank in merged["hosts"]:
        ph = merged["per_host"][str(rank)]
        _extend(ph["counters"], str(rank))
        _extend(ph["gauges"], str(rank))
    _extend(merged["counters"], "fleet")
    _extend(merged["gauges"], "fleet")
    for rank, age in sorted(merged["snapshot_age_seconds"].items()):
        lines.append(_prom_sample(
            "insight.fleet_snapshot_age_seconds", age, rank))
    return "\n".join(ln for ln in lines if ln) + "\n"


#: source names scanned, in priority order, for a host's representative
#: step-time EWMA in its snapshot
_STEP_SOURCES = ("parallel.train_step", "trainer.step", "serve.step",
                 "serve.decode")


def relative_slowness(lease_dir=None):
    """{rank: ratio} of each host's step-time EWMA to the fleet median,
    read from the lease-dir snapshots — mx.fleet's per-host straggler
    signal (cut at ``insight.straggler_ratio``), replacing the
    one-size-fits-all ``fleet.slow_fraction`` deadline for hosts that
    publish insight state.  {} without at least two reporting hosts."""
    snaps = read_snapshots(lease_dir)
    ewmas = {}
    for rank, p in snaps.items():
        drift = (p.get("insight") or {}).get("drift") or {}
        val = None
        for src in _STEP_SOURCES:
            d = drift.get(src)
            if d and d.get("ewma"):
                val = float(d["ewma"])
                break
        if val is None:
            for d in drift.values():
                if d and d.get("ewma"):
                    val = float(d["ewma"])
                    break
        if val:
            ewmas[rank] = val
    if len(ewmas) < 2:
        return {}
    med = statistics.median(ewmas.values())
    if med <= 0:
        return {}
    return {rank: v / med for rank, v in ewmas.items()}


# arm from the environment at import (MXNET_INSIGHT=1), mirroring
# telemetry/fault, so spawned workers and plain scripts inherit it
if _config.get("insight.enable"):
    enable()
