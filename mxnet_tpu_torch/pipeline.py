"""mx.pipeline — the sync guard and the deferred host-fetch window.

Port of the first part of ``mxnet_tpu/pipeline.py`` (:122-373):
:func:`sync_guard` is the transfer-guard context the tests use to *prove*
a code path performs no host sync: every instrumented sync site (the
Trainer's grad norm, forced window evictions) reports into active guards
via :func:`note_host_sync`, and ``arm_site_counts`` lets telemetry and
the blackbox recorder keep process-lifetime per-site counts
(``telemetry.snapshot()["sync_sites"]``). :class:`DeferredWindow` keeps
per-step scalar reads (the Trainer's grad norm) as device values in a
bounded FIFO and fetches them at ``drain()`` or on overflow, so the step
loop never reads a fresh value. ``DevicePrefetcher`` and the placement
helpers are not ported yet (``ROADMAP.md`` Queue 1, item 7).

Disabled cost: the sync probes gate on one module attribute read
(``_guard_depth``), mirroring ``fault._active`` / ``telemetry._active``.
"""
from __future__ import annotations

import threading

from . import config as _config
from . import telemetry as _telemetry
from . import trace as _trace

__all__ = ["DeferredWindow", "sync_guard", "note_host_sync", "SyncGuard",
           "arm_site_counts", "sync_site_counts", "reset_site_counts"]

_telemetry.declare_metric(
    "pipeline.deferred_evictions_total", "counter",
    "DeferredWindow overflows forced to fetch on the hot path")
_telemetry.declare_metric(
    "pipeline.host_syncs_total", "counter",
    "host syncs observed by the instrumented sync sites, by site "
    "(recorded once mx.telemetry or mx.blackbox arms the site counter)")


# ---------------------------------------------------------------------------
# transfer guard: prove a code path performs no host sync
# ---------------------------------------------------------------------------

#: hot-path gate — sync sites read this one attribute; 0 keeps every probe
#: a single no-op branch (same design as fault._active)
_guard_depth = 0
_guard_lock = threading.Lock()
_tls = threading.local()


class SyncGuard:
    """Counter handed back by :func:`sync_guard`: total host syncs seen
    while active, broken down by site name in ``sites``."""

    __slots__ = ("count", "sites")

    def __init__(self):
        self.count = 0
        self.sites = {}

    def _note(self, site):
        self.count += 1
        self.sites[site] = self.sites.get(site, 0) + 1


class sync_guard:
    """Context manager counting host syncs on the *current thread*:

        with mx.pipeline.sync_guard() as g:
            run_steps()
        assert g.count == 0, g.sites

    Thread-local by design — background prefetch transfers do not count
    against a guarded training loop.
    """

    def __enter__(self):
        global _guard_depth
        g = SyncGuard()
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(g)
        with _guard_lock:
            _guard_depth += 1
        return g

    def __exit__(self, *exc):
        global _guard_depth
        _tls.stack.pop()
        with _guard_lock:
            _guard_depth -= 1
        return False


#: process-lifetime host syncs by call site, fed by note_host_sync; read
#: via sync_site_counts() (telemetry.snapshot()["sync_sites"] and
#: blackbox bundles).  Only populated while some owner holds the arm
#: sentinel below or a guard keeps _guard_depth nonzero.
_site_totals: dict[str, int] = {}
#: owners (mx.telemetry, mx.blackbox) currently biasing _guard_depth so
#: sync sites report with no user guard on the thread
_armed_owners: set = set()


def arm_site_counts(owner, on=True):
    """Idempotently bias ``_guard_depth`` by one while any ``owner``
    (telemetry / blackbox) wants process-lifetime per-site sync counts,
    so the instrumented call sites report without a :func:`sync_guard`
    active on the thread.  :class:`SyncGuard` semantics are untouched —
    only guards on the calling thread's stack accumulate into guard
    objects.  Returns True while armed."""
    global _guard_depth
    with _guard_lock:
        had = bool(_armed_owners)
        if on:
            _armed_owners.add(owner)
        else:
            _armed_owners.discard(owner)
        have = bool(_armed_owners)
        if have and not had:
            _guard_depth += 1
        elif had and not have:
            _guard_depth -= 1
    return bool(_armed_owners)


def sync_site_counts():
    """Process-lifetime host-sync counts by call site (sorted copy)."""
    with _guard_lock:
        return dict(sorted(_site_totals.items()))


def reset_site_counts():
    """Drop the per-site sync totals (telemetry.reset test isolation);
    the armed owners and guard depth are untouched."""
    with _guard_lock:
        _site_totals.clear()


def note_host_sync(site):
    """Report one host sync into every guard active on this thread and
    into the process-lifetime per-site totals.  Call sites gate on
    ``pipeline._guard_depth`` first so the disabled cost is one
    attribute read."""
    stack = getattr(_tls, "stack", None)
    if stack:
        for g in stack:
            g._note(site)
    with _guard_lock:
        _site_totals[site] = _site_totals.get(site, 0) + 1
    if _telemetry._active:
        _telemetry.inc("pipeline.host_syncs_total", site=site)


# ---------------------------------------------------------------------------
# deferred host-fetch window
# ---------------------------------------------------------------------------

def _fetch(value):
    """Device scalar (tensor / mx ndarray / nested tuple) -> float(s): the
    one place a deferred value is read, one ``.item()`` each."""
    if isinstance(value, tuple):
        return tuple(_fetch(v) for v in value)
    if isinstance(value, (int, float)):
        return float(value)
    return float(getattr(value, "_data", value).item())


class DeferredWindow:
    """Bounded FIFO of ``(device_value, sink)`` pairs whose host fetch is
    deferred off the step loop.

    ``push()`` enqueues a device scalar (or tuple of scalars) and the
    callback that consumes its float value(s); nothing touches the host
    until ``drain()`` — epoch boundary, explicit ``.get()`` — or until the
    window overflows, in which case the oldest entry is fetched in place
    (by then its value is ``window`` steps old and almost always already
    computed, but the fetch is still counted as a host sync so
    ``sync_guard`` stays honest).
    """

    def __init__(self, window=None):
        self._window = max(0, int(
            window if window is not None
            else _config.get("pipeline.deferred_window")))
        self._pending = []

    def __len__(self):
        return len(self._pending)

    def push(self, value, sink):
        self._pending.append((value, sink))
        while len(self._pending) > self._window:
            if _guard_depth:
                note_host_sync("deferred_evict")
            if _telemetry._active:
                _telemetry.inc("pipeline.deferred_evictions_total")
            self._drain_one()

    def _drain_one(self):
        value, sink = self._pending.pop(0)
        sink(_fetch(value))

    def drain(self):
        """Fetch and deliver every pending value, oldest first."""
        if _trace._active and self._pending:
            with _trace.span("pipeline.drain", category="pipeline",
                             pending=len(self._pending)):
                while self._pending:
                    self._drain_one()
            return
        while self._pending:
            self._drain_one()

    def clear(self):
        """Drop pending values without fetching (metric reset)."""
        self._pending.clear()
