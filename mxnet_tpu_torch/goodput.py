"""mx.goodput — fleet-wide wall-clock goodput ledger with badput
attribution and SLO error-budget burn rates.

Three planes (docs/OBSERVABILITY.md "Goodput & SLO budgets"):

- **Ledger** — a per-host non-overlapping interval ledger attributes
  every wall-clock second of a run to exactly one state (``compute``,
  ``input_stall``, ``h2d``, ``compile``, ``checkpoint_save``,
  ``restore``, ``restart``, ``parked``, ``retune``, ``drain``,
  ``rollover``, ``idle``) plus a capacity axis (``degraded_capacity``: running at
  dp2 when the target layout is dp4 counts 50% of every wall-second
  as badput, scaled from the live/target ``MeshConfig`` sizes).
  Feeds are the planes that already exist: the step-time and
  input-stall histograms (via :func:`telemetry.add_sample_listener`),
  ``TrainState.save``/``load_latest_valid`` brackets,
  ``FleetSupervisor`` degrade/park/re-expand transitions, ``Retuner``
  re-searches, the serve drain path, and ``mx.servefleet`` rolling
  weight updates (``rollover`` brackets the whole drain → reload →
  re-warmup → canary window per replica, outranking the nested drain
  and compile claims so update downtime is attributed, not lost).
  Overlaps are resolved by a
  fixed priority order (:data:`PRIORITY`) and un-claimed time is
  ``idle``, so the **conservation oracle** — sum of buckets ==
  elapsed wall clock — holds by construction, epsilon-bounded only by
  float accumulation and late-arriving claims (counted separately).
- **Fleet view** — each host publishes an atomic ``goodput-<rank>.json``
  snapshot next to the mx.fleet heartbeat leases (riding
  ``HealthPlane.beat`` like insight's); :func:`merge_snapshots` turns
  them into capacity-weighted fleet *device-second* totals served at
  ``GET /goodput`` and as the ``goodput`` plane in
  ``TrainingTelemetry`` run reports.
- **SLO layer** — a declared ``goodput.target`` ratio turns the ledger
  into multi-window (5m/1h) error-budget burn-rate gauges wired into
  ``telemetry.register_health``: a sustained burn past
  ``goodput.burn_threshold`` flips ``/healthz`` 503 — the signal the
  serve autoscaler (ROADMAP item 1) consumes.  The serving-side twin
  (``serve.slo_ttft_ms``/``serve.slo_tpot_ms``) lives in the engine.

Cost discipline matches telemetry/trace/fault/insight: disabled (the
default), every hook is one module-attribute read.

Copy of ``mxnet_tpu/goodput.py`` (the port imports nothing of the JAX
package): the ledger, claims, burn rates, ``healthz`` and the snapshot
files are the reference's. The port feeds it from the Trainer's
``trainer.step_seconds``, the serve engine's ``serve.step_seconds`` and
drain bracket, and capture times (``cached_graph.compile_seconds``);
``mx.fleet``, which publishes the snapshots on its heartbeat, is not
ported yet.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time

from . import config as _config
from . import telemetry as _telemetry

__all__ = [
    "PRIORITY", "STATES",
    "enable", "disable", "configure", "active", "reset",
    "note", "begin", "end", "phase", "set_capacity", "set_devices",
    "resolve_claims", "summary", "last_summary", "bench_fields",
    "burn_rates", "healthz",
    "write_snapshot", "maybe_snapshot", "read_snapshots",
    "merge_snapshots", "endpoint_report",
]

_telemetry.declare_metric(
    "goodput.fraction", "gauge",
    "Fraction of elapsed wall clock attributed to compute by the "
    "goodput ledger (capacity-weighted; 1.0 means every paid second "
    "produced training/serving progress).")
_telemetry.declare_metric(
    "goodput.state_seconds", "gauge",
    "Cumulative wall-clock seconds the goodput ledger attributes to "
    "each state, by state — the badput waterfall behind "
    "goodput.fraction.")
_telemetry.declare_metric(
    "goodput.burn_rate", "gauge",
    "Error-budget burn rate against goodput.target, by trailing "
    "window (5m/1h): 1.0 spends the budget exactly, >1 burns it "
    "faster; both windows past goodput.burn_threshold flips /healthz "
    "503.")
_telemetry.declare_metric(
    "goodput.snapshots_written_total", "counter",
    "Fleet goodput ledger snapshots atomically published next to the "
    "heartbeat leases.")

#: Overlap resolution order, highest priority first.  When two claims
#: cover the same instant (a checkpoint save inside a restart bracket,
#: a compile sample under a retune), the second counts the wall clock
#: once, to the highest-priority state.  ``idle`` is the residual —
#: never claimed, it is whatever no feed accounted for — and
#: ``degraded_capacity`` is the capacity axis, split off every state
#: but ``parked`` while the live mesh is smaller than the target.
PRIORITY = ("restart", "restore", "rollover", "checkpoint_save", "parked",
            "retune", "drain", "compile", "input_stall", "h2d", "compute")

#: Every bucket a summary can contain.
STATES = PRIORITY + ("degraded_capacity", "idle")

_RANK = {s: i for i, s in enumerate(PRIORITY)}

#: settle claims into the compacted buckets once this many accumulate
_CLAIM_CAP = 4096
#: never settle time closer than this to "now" (late samples still land)
_SETTLE_GRACE = 30.0
#: burn-rate windows, seconds (multi-window: page only when both burn)
BURN_WINDOWS = (("5m", 300.0), ("1h", 3600.0))

_lock = threading.RLock()
_active = False
_snap_last = 0.0

SNAPSHOT_PREFIX = "goodput-"


def resolve_claims(claims, t0, t1, cap_marks=None):
    """Pure sweep-line resolution of ``(start, stop, state)`` claims
    over the window ``[t0, t1]``: each elementary segment goes to the
    highest-priority covering state, un-claimed segments to ``idle``,
    and while the capacity step function (``cap_marks``: sorted
    ``(time, ratio)`` pairs) is below 1.0 the lost share of every
    non-``parked`` second goes to ``degraded_capacity``.  Returns a
    bucket dict whose values sum to exactly ``t1 - t0`` (up to float
    accumulation) — the conservation oracle holds by construction.
    """
    buckets: dict[str, float] = {}
    if t1 <= t0:
        return buckets
    marks = sorted(cap_marks) if cap_marks else [(t0, 1.0)]
    pts = {t0, t1}
    clipped = []
    for (a, b, s) in claims:
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        clipped.append((a, b, s))
        pts.add(a)
        pts.add(b)
    for (t, _ratio) in marks:
        if t0 < t < t1:
            pts.add(t)
    edges = sorted(pts)
    for a, b in zip(edges, edges[1:]):
        mid = (a + b) / 2.0
        dt = b - a
        best = None
        for (ca, cb, s) in clipped:
            if ca <= mid < cb and (best is None or _RANK[s] < _RANK[best]):
                best = s
        ratio = 1.0
        for (t, r) in marks:
            if t <= mid:
                ratio = r
            else:
                break
        state = "idle" if best is None else best
        if state == "parked" or ratio >= 1.0:
            buckets[state] = buckets.get(state, 0.0) + dt
        else:
            buckets[state] = buckets.get(state, 0.0) + dt * ratio
            buckets["degraded_capacity"] = \
                buckets.get("degraded_capacity", 0.0) + dt * (1.0 - ratio)
    return buckets


class _Ledger:
    """Per-host claim store.  Claims accumulate unsettled (so late,
    retroactive samples still resolve against concurrent brackets) and
    are periodically compacted into ``settled`` buckets behind a safe
    frontier; :meth:`summary` resolves the live tail on demand."""

    __slots__ = ("t0", "frontier", "settled", "claims", "open",
                 "next_token", "capacity", "cap_marks", "devices",
                 "target_devices", "late_dropped_s", "history",
                 "hist_last")

    def __init__(self, now=None):
        now = time.monotonic() if now is None else now
        self.t0 = now
        self.frontier = now          # settled up to here
        self.settled: dict[str, float] = {}
        self.claims: list[tuple] = []    # (start, stop, state), unsettled
        self.open: dict[int, tuple] = {}  # token -> (start, state)
        self.next_token = 0
        self.capacity = 1.0
        self.cap_marks: list[tuple] = [(now, 1.0)]
        self.devices = 1
        self.target_devices = 1
        self.late_dropped_s = 0.0    # claims fully behind the frontier
        self.history = collections.deque(maxlen=4096)  # (t, elapsed, compute)
        self.hist_last = 0.0

    def claim(self, state, start, stop, now=None):
        if state not in _RANK:
            raise ValueError(f"unknown goodput state {state!r}; "
                             f"expected one of {PRIORITY}")
        if stop <= self.frontier:
            self.late_dropped_s += max(0.0, stop - start)
            return
        self.claims.append((max(start, self.frontier), stop, state))
        if len(self.claims) > _CLAIM_CAP:
            self.compact(time.monotonic() if now is None else now)

    def compact(self, now):
        """Settle everything behind ``min(open brackets, now - grace)``
        into the cumulative buckets and drop the resolved claims."""
        safe = now - _SETTLE_GRACE
        if self.open:
            safe = min(safe, min(t for (t, _s) in self.open.values()))
        if safe <= self.frontier:
            return
        part = resolve_claims(self.claims, self.frontier, safe,
                              self.cap_marks)
        for s, v in part.items():
            self.settled[s] = self.settled.get(s, 0.0) + v
        self.claims = [(max(a, safe), b, s) for (a, b, s) in self.claims
                       if b > safe]
        base = 1.0
        keep = []
        for (t, r) in self.cap_marks:
            if t <= safe:
                base = r
            else:
                keep.append((t, r))
        self.cap_marks = [(safe, base)] + keep
        self.frontier = safe

    def resolve(self, now):
        """Settled + live buckets as of ``now`` (no state mutated)."""
        live = list(self.claims)
        live.extend((t, now, s) for (t, s) in self.open.values())
        buckets = dict(self.settled)
        for s, v in resolve_claims(live, self.frontier, now,
                                   self.cap_marks).items():
            buckets[s] = buckets.get(s, 0.0) + v
        return buckets


_ledger = _Ledger()


# -- switches ----------------------------------------------------------------

def active():
    return _active


def _compute_samples(value):
    note("compute", value)


def _stall_samples(value):
    note("input_stall", value)


def _compile_samples(value):
    note("compile", value)


def enable(on=True):
    """Flip the goodput plane.  Enabling resets the ledger origin to
    "now", registers the ``goodput`` /healthz provider and the
    raw-sample listeners that feed ``compute`` / ``input_stall`` /
    ``compile`` from histograms the stack already records."""
    global _active, _ledger
    was = _active
    _active = bool(on)
    if _active and not was:
        with _lock:
            _ledger = _Ledger()
        _telemetry.register_health("goodput", healthz)
        _telemetry.add_sample_listener("trainer.step_seconds",
                                       _compute_samples, tag="goodput")
        _telemetry.add_sample_listener("serve.step_seconds",
                                       _compute_samples, tag="goodput")
        _telemetry.add_sample_listener("pipeline.input_stall_seconds",
                                       _stall_samples, tag="goodput")
        _telemetry.add_sample_listener("cached_graph.compile_seconds",
                                       _compile_samples, tag="goodput")
    elif was and not _active:
        _telemetry.unregister_health("goodput")
        _telemetry.remove_sample_listener("trainer.step_seconds",
                                          tag="goodput")
        _telemetry.remove_sample_listener("serve.step_seconds",
                                          tag="goodput")
        _telemetry.remove_sample_listener("pipeline.input_stall_seconds",
                                          tag="goodput")
        _telemetry.remove_sample_listener("cached_graph.compile_seconds",
                                          tag="goodput")
    return _active


def disable():
    return enable(False)


def configure():
    """Re-arm from the knob/environment state (MXNET_GOODPUT)."""
    return enable(bool(_config.get("goodput.enable")))


def reset():
    """Fresh ledger (origin = now); the enabled/disabled state and
    listener registrations are kept."""
    global _ledger, _snap_last
    with _lock:
        _ledger = _Ledger()
        _snap_last = 0.0


# -- recording ---------------------------------------------------------------

def note(state, seconds, end_time=None):
    """Record a retroactive claim: the ``seconds`` leading up to
    ``end_time`` (default now) were spent in ``state``.  This is the
    sample-listener feed — a step-time histogram observation arrives
    *after* the interval it measures.  No-op while disabled."""
    if not _active or seconds <= 0.0:
        return
    now = time.monotonic() if end_time is None else end_time
    with _lock:
        _ledger.claim(state, now - seconds, now, now=now)


def begin(state):
    """Open a bracket: wall clock from now until :func:`end` is claimed
    for ``state``.  Returns an opaque token (None while disabled — safe
    to pass straight back to :func:`end`)."""
    if not _active:
        return None
    now = time.monotonic()
    with _lock:
        tok = _ledger.next_token
        _ledger.next_token += 1
        _ledger.open[tok] = (now, state)
    return tok


def end(token):
    """Close a bracket opened by :func:`begin` (no-op for None or after
    a :func:`reset`)."""
    if token is None:
        return
    now = time.monotonic()
    with _lock:
        opened = _ledger.open.pop(token, None)
        if opened is not None:
            _ledger.claim(opened[1], opened[0], now, now=now)


@contextlib.contextmanager
def phase(state):
    """Context-manager form of :func:`begin`/:func:`end`; free when
    disabled."""
    tok = begin(state)
    try:
        yield
    finally:
        end(tok)


def set_capacity(current, target):
    """Record a capacity transition: the live mesh now has ``current``
    of ``target`` devices.  While the ratio is below 1.0 the lost share
    of every wall-second is attributed to ``degraded_capacity`` (dp2
    when the target layout is dp4 -> 50% of device-seconds badput)."""
    if not _active:
        return
    ratio = 1.0
    if target and target > 0:
        ratio = max(0.0, min(1.0, float(current) / float(target)))
    now = time.monotonic()
    with _lock:
        _ledger.capacity = ratio
        _ledger.cap_marks.append((now, ratio))
        _ledger.target_devices = int(target) if target else 1


def set_devices(n):
    """This host's device count — the weight :func:`merge_snapshots`
    uses to turn per-host wall-seconds into fleet device-seconds."""
    if not _active:
        return
    with _lock:
        _ledger.devices = max(1, int(n))


# -- summaries ---------------------------------------------------------------

def _badput_top(buckets, k=2):
    bad = [(s, v) for s, v in buckets.items()
           if s not in ("compute", "idle") and v > 0.0]
    bad.sort(key=lambda kv: kv[1], reverse=True)
    return [[s, round(v, 4)] for s, v in bad[:k]]


def summary(now=None):
    """Resolve the ledger into its bucket waterfall.  The conservation
    oracle — ``attributed_s == elapsed_s`` within epsilon, zero
    overlaps — is structural: test_goodput.py holds it through every
    chaos drill."""
    now = time.monotonic() if now is None else now
    with _lock:
        led = _ledger
        buckets = led.resolve(now)
        elapsed = max(0.0, now - led.t0)
        compute = buckets.get("compute", 0.0)
        if now - led.hist_last >= 1.0:
            led.hist_last = now
            led.history.append((now, elapsed, compute))
        devices = led.devices
        capacity = led.capacity
        late = led.late_dropped_s
    attributed = sum(buckets.values())
    frac = compute / elapsed if elapsed > 0 else 0.0
    out = {
        "elapsed_s": round(elapsed, 6),
        "attributed_s": round(attributed, 6),
        "conservation_error_s": round(abs(elapsed - attributed), 6),
        "late_dropped_s": round(late, 6),
        "goodput_fraction": round(frac, 6),
        "buckets": {s: round(v, 6) for s, v in sorted(buckets.items())},
        "badput_top": _badput_top(buckets),
        "capacity_ratio": capacity,
        "devices": devices,
    }
    target = float(_config.get("goodput.target"))
    if 0.0 < target < 1.0:
        out["slo"] = {"target": target, "burn": burn_rates(now=now)}
    if _telemetry._active:
        _telemetry.set_gauge("goodput.fraction", round(frac, 6))
        for s, v in buckets.items():
            _telemetry.set_gauge("goodput.state_seconds", round(v, 4),
                                 state=s)
    return out


def last_summary():
    """The run-report plane: :func:`summary` when the ledger is armed
    and has attributed anything, else None (the report stays clean on
    runs that never enabled goodput)."""
    if not _active:
        return None
    with _lock:
        led = _ledger
        empty = not (led.settled or led.claims or led.open)
    if empty:
        return None
    return summary()


def bench_fields():
    """Per-row fields for bench.py train rows: the measured goodput
    fraction plus the top-2 badput causes.  {} while disabled so the
    bench schema is unchanged unless the ledger is armed."""
    if not _active:
        return {}
    s = summary()
    return {"goodput_fraction": s["goodput_fraction"],
            "badput_top": s["badput_top"]}


# -- SLO layer ---------------------------------------------------------------

def burn_rates(now=None):
    """Error-budget burn per trailing window against ``goodput.target``:
    ``(1 - windowed_goodput) / (1 - target)``.  1.0 spends the budget
    exactly; the classic multi-window page is both windows > threshold.
    {} until a target is declared."""
    target = float(_config.get("goodput.target"))
    if not (0.0 < target < 1.0):
        return {}
    now = time.monotonic() if now is None else now
    with _lock:
        led = _ledger
        compute_now = led.resolve(now).get("compute", 0.0)
        elapsed_now = max(0.0, now - led.t0)
        if now - led.hist_last >= 1.0:
            led.hist_last = now
            led.history.append((now, elapsed_now, compute_now))
        hist = list(led.history)
    budget = 1.0 - target
    out = {}
    for label, window in BURN_WINDOWS:
        cut = now - window
        base_t, base_elapsed, base_compute = led.t0, 0.0, 0.0
        for (t, e, c) in hist:
            if t <= cut:
                base_t, base_elapsed, base_compute = t, e, c
            else:
                break
        d_elapsed = elapsed_now - base_elapsed
        if d_elapsed <= 0:
            continue
        g = max(0.0, min(1.0, (compute_now - base_compute) / d_elapsed))
        burn = (1.0 - g) / budget
        out[label] = round(burn, 4)
        if _telemetry._active:
            _telemetry.set_gauge("goodput.burn_rate", round(burn, 4),
                                 window=label)
    return out


def healthz():
    """/healthz provider: unhealthy when the error budget burns past
    ``goodput.burn_threshold`` on *every* window (multi-window rule, so
    a 5-minute blip alone never pages).  Vacuously healthy until
    ``goodput.target`` is declared."""
    burn = burn_rates()
    thresh = float(_config.get("goodput.burn_threshold"))
    breach = bool(burn) and all(b > thresh for b in burn.values())
    return {"ok": not breach, "burn": burn, "threshold": thresh}


# -- fleet snapshots & merge -------------------------------------------------

def _snapshot_path(lease_dir, rank):
    return os.path.join(lease_dir, f"{SNAPSHOT_PREFIX}{int(rank)}.json")


def write_snapshot(lease_dir=None, rank=0):
    """Atomically publish this host's ledger summary as
    ``goodput-<rank>.json`` next to the heartbeat leases (tmp +
    ``os.replace``, so readers never see a torn file).  Returns the
    path, or None without a lease dir."""
    lease_dir = lease_dir or _config.get("fleet.lease_dir")
    if not lease_dir:
        return None
    payload = {"rank": int(rank), "pid": os.getpid(),
               "time": time.time(), "summary": summary()}
    os.makedirs(lease_dir, exist_ok=True)
    path = _snapshot_path(lease_dir, rank)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(json.dumps(payload))
    os.replace(tmp, path)
    if _telemetry._active:
        _telemetry.inc("goodput.snapshots_written_total")
    return path


def maybe_snapshot(lease_dir=None, rank=0, interval=None):
    """Rate-limited :func:`write_snapshot` — the fleet heartbeat hook
    (rides ``HealthPlane.beat``, so snapshot cadence needs no thread
    of its own)."""
    global _snap_last
    if not _active:
        return None
    if interval is None:
        interval = float(_config.get("goodput.snapshot_interval"))
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
    """{rank: payload} for every well-formed ``goodput-*.json``
    snapshot in the lease dir (torn/foreign files skipped)."""
    lease_dir = lease_dir or _config.get("fleet.lease_dir")
    out = {}
    if not lease_dir or not os.path.isdir(lease_dir):
        return out
    for name in sorted(os.listdir(lease_dir)):
        if not (name.startswith(SNAPSHOT_PREFIX) and
                name.endswith(".json")):
            continue
        try:
            with open(os.path.join(lease_dir, name)) as f:
                payload = json.load(f)
            out[int(payload["rank"])] = payload
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return out


def merge_snapshots(snaps):
    """Merge per-host ledgers into capacity-weighted fleet
    *device-second* totals: each host's wall-second buckets scale by
    its device count, so a dp2-of-dp4 fleet's lost half shows up with
    the same weight as the half that ran."""
    device_seconds: dict[str, float] = {}
    elapsed_dev = 0.0
    by_host = {}
    for rank, payload in sorted(snaps.items()):
        s = payload.get("summary") or {}
        dev = max(1, int(s.get("devices", 1)))
        elapsed_dev += float(s.get("elapsed_s", 0.0)) * dev
        for state, sec in (s.get("buckets") or {}).items():
            device_seconds[state] = \
                device_seconds.get(state, 0.0) + float(sec) * dev
        by_host[str(rank)] = {
            "devices": dev,
            "elapsed_s": s.get("elapsed_s", 0.0),
            "goodput_fraction": s.get("goodput_fraction", 0.0),
            "age_s": max(0.0, time.time() - float(payload.get("time", 0))),
        }
    compute = device_seconds.get("compute", 0.0)
    frac = compute / elapsed_dev if elapsed_dev > 0 else 0.0
    return {
        "hosts": len(snaps),
        "elapsed_device_seconds": round(elapsed_dev, 4),
        "device_seconds": {s: round(v, 4)
                           for s, v in sorted(device_seconds.items())},
        "goodput_fraction": round(frac, 6),
        "badput_top": _badput_top(device_seconds),
        "by_host": by_host,
    }


def endpoint_report(lease_dir=None):
    """The ``GET /goodput`` payload: this host's ledger plus the merged
    fleet view when heartbeat-lease snapshots are present."""
    snaps = read_snapshots(lease_dir)
    return {"enabled": _active,
            "local": last_summary(),
            "fleet": merge_snapshots(snaps) if snaps else None}


if _config.get("goodput.enable"):
    enable()
