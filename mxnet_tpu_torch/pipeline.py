"""mx.pipeline — the sync guard, the deferred host-fetch window and the
device prefetcher.

Port of ``mxnet_tpu/pipeline.py``. :func:`sync_guard` is the transfer-guard context the tests use to *prove*
a code path performs no host sync: every instrumented sync site (the
Trainer's grad norm, forced window evictions) reports into active guards
via :func:`note_host_sync`, and ``arm_site_counts`` lets telemetry and
the blackbox recorder keep process-lifetime per-site counts
(``telemetry.snapshot()["sync_sites"]``). :class:`DeferredWindow` keeps
per-step scalar reads (the Trainer's grad norm) as device values in a
bounded FIFO and fetches them at ``drain()`` or on overflow, so the step
loop never reads a fresh value.

:class:`DevicePrefetcher` moves the batches of any iterator to the card
on a background thread, ``depth`` batches ahead. Each host leaf is copied
into a pinned staging buffer (a leaf already pinned, or one its source
wrote into a staging buffer, as the DataLoader's worker pump does, is
copied from directly) and from there to the card on a side CUDA stream;
the copy's
event is recorded, and a staging buffer is handed out again only after
its event completed, waited on by the prefetch thread. The consumer's
stream waits on the event (``wait_event``, no host sync) and the card
tensor is tied to it (``record_stream``), so the caching allocator does
not reuse its memory while the step still reads it. The stall recovery
is the reference's: every fetch -> put -> offer runs under one source
lock, and a consumer that waits past ``pipeline.stall_timeout`` hands the
source to a replacement thread (fault point ``pipeline.prefetch_stall``).
``prefetch_to_device(batches, True)`` targets the card and raises without
one; an explicit ``"cpu"`` target runs the same machinery on the host.

Disabled cost: the sync probes gate on one module attribute read
(``_guard_depth``), mirroring ``fault._active`` / ``telemetry._active``.
"""
from __future__ import annotations

import queue
import threading
import time

import torch

from . import config as _config
from . import fault as _fault
from . import goodput as _goodput
from . import telemetry as _telemetry
from . import trace as _trace
from .base import MXNetError

__all__ = ["DevicePrefetcher", "prefetch_to_device", "DeferredWindow",
           "maybe_device_put", "ensure_sharded", "sync_guard",
           "note_host_sync", "SyncGuard", "take", "arm_site_counts",
           "sync_site_counts", "reset_site_counts"]


def take(source, n):
    """Yield at most ``n`` batches from ``source``, then release it:
    ``close()`` is called on the iterator (or the source) when either side
    defines it, so peeling a batch off a DevicePrefetcher or a
    worker-backed DataLoader does not leave its machinery running."""
    it = iter(source)
    try:
        for _ in range(int(n)):
            try:
                yield next(it)
            except StopIteration:
                return
    finally:
        close = getattr(it, "close", None) or getattr(source, "close", None)
        if callable(close):
            try:
                close()
            except Exception:  # noqa: BLE001 - best-effort release
                pass


_telemetry.declare_metric(
    "pipeline.input_stall_seconds", "histogram",
    "time the training loop blocked waiting on the device prefetch queue",
    buckets=_telemetry.TIME_BUCKETS)
_telemetry.declare_metric(
    "pipeline.inflight_depth", "gauge",
    "prefetched batches buffered when the loop asked for one")
_telemetry.declare_metric(
    "pipeline.batches_total", "counter",
    "batches delivered through DevicePrefetchers")
_telemetry.declare_metric(
    "pipeline.h2d_bytes_total", "counter",
    "bytes moved host->device by prefetch puts (already-resident leaves "
    "are skipped and not counted)")
_telemetry.declare_metric(
    "pipeline.stall_recovered_total", "counter",
    "prefetch threads declared stalled and replaced")

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


# ---------------------------------------------------------------------------
# device placement helpers
# ---------------------------------------------------------------------------

def _target_device(target):
    """The ``torch.device`` of a prefetch target: None / True the card
    (raises without one), else a device, its name or a Context."""
    if target is None or target is True:
        if not torch.cuda.is_available():
            raise MXNetError(
                "prefetch to device: no CUDA device available; pass an "
                "explicit target such as 'cpu' to stage on the host")
        return torch.device("cuda", torch.cuda.current_device())
    from .context import resolve_device
    return resolve_device(target)


def _leaf_tensor(leaf):
    """(tensor, kind) of an array leaf, or (None, None) for a payload that
    is not an array (ids, metadata), which passes through."""
    from .numpy.multiarray import ndarray
    if isinstance(leaf, ndarray):
        return leaf._data, "nd"
    if isinstance(leaf, torch.Tensor):
        return leaf, "tensor"
    if hasattr(leaf, "__array__") and not isinstance(leaf, (str, bytes)):
        import numpy as onp
        return torch.from_numpy(onp.ascontiguousarray(leaf)), "tensor"
    return None, None


def maybe_device_put(raw, target=None):
    """Place ``raw`` (a tensor, an ``mx.np`` array or a numpy array) on
    ``target`` (None: the card), skipping a value already there. Returns
    ``(value, moved)``."""
    from .numpy.multiarray import _wrap
    dev = _target_device(target)
    t, kind = _leaf_tensor(raw)
    if t is None:
        return raw, False
    if t.device == dev:
        return (raw if kind == "nd" else t), False
    out = t.to(dev)
    return (_wrap(out) if kind == "nd" else out), True


def ensure_sharded(raw, sharding):
    """Place one value against ``sharding`` (one card: a device target),
    skipping the put when it is already there; real transfers count in
    ``pipeline.h2d_bytes_total``."""
    out, moved = maybe_device_put(raw, sharding)
    if moved and _telemetry._active:
        _telemetry.inc("pipeline.h2d_bytes_total",
                       _leaf_tensor(out)[0].nbytes)
    return out


# ---------------------------------------------------------------------------
# device prefetcher
# ---------------------------------------------------------------------------

_DONE = object()


class _Raise:
    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class _StagingRing:
    """Pinned host staging buffers by (shape, dtype), each returned with
    the event of the copy that reads it. ``acquire`` hands a buffer out
    again only after that event completed (the prefetch thread waits on
    it), so a copy in flight never sees its source overwritten. At most
    ``cap`` buffers a key; ``waits`` counts the acquisitions that had to
    wait on a copy. A source running in the prefetch thread (the
    DataLoader's worker pump) may fill a buffer itself; the prefetcher
    then copies from it directly and takes it back (``lent``)."""

    def __init__(self, cap):
        self._cap = max(1, int(cap))
        self._free = {}
        self._out = {}  # id -> buffer handed out and not yet released
        self.waits = 0

    def acquire(self, shape, dtype):
        pool = self._free.setdefault((tuple(shape), dtype), [])
        if pool and (len(pool) >= self._cap or pool[0][1].query()):
            buf, ev = pool.pop(0)
            if not ev.query():
                self.waits += 1
                ev.synchronize()
        else:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        self._out[id(buf)] = buf
        return buf

    def lent(self, t):
        """Whether ``t`` is a buffer of this ring that is handed out."""
        return self._out.get(id(t)) is t

    def release(self, buf, event):
        del self._out[id(buf)]
        self._free.setdefault((tuple(buf.shape), buf.dtype), []).append(
            (buf, event))


class _Ready:
    """A prefetched batch and its (copy event, card tensor) pairs, which
    its consumer waits on."""

    __slots__ = ("batch", "copies")

    def __init__(self, batch, copies):
        self.batch = batch
        self.copies = copies


class DevicePrefetcher:
    """Background-thread device placement over any batch iterator.

    ``source`` yields host batches (arrays or tuples / lists of them); the
    prefetch thread places each leaf on ``shardings`` (None: the card; a
    single target or a per-position sequence of targets) and buffers up
    to ``depth`` ready batches, so the copy of batch N+1 overlaps step
    N. Leaves already on their target pass through without a copy; leaves
    keep their kind (``mx.np`` arrays come back as arrays, tensors and
    numpy leaves as tensors). On the card the copies run on a side stream
    from pinned memory (see the module docstring).

    Stall recovery (reference: pipeline.py DevicePrefetcher): if no batch
    arrives within ``stall_timeout`` the thread is presumed wedged and a
    replacement takes over the same source iterator under a lock; the
    whole fetch -> put -> offer runs under that lock, so a thread that was
    merely slow still delivers its batch first and nothing is lost or
    reordered.
    """

    def __init__(self, source, shardings=None, depth=None,
                 stall_timeout=None):
        self._source = iter(source)
        self._shardings = shardings
        self._depth = max(1, int(
            depth if depth is not None
            else _config.get("pipeline.prefetch_depth")))
        self._stall_timeout = float(
            stall_timeout if stall_timeout is not None
            else _config.get("pipeline.stall_timeout"))
        # a card target without one raises here; ``to_card``: every leaf
        # goes to a card, so a source may fill the staging ring directly
        self.to_card = all(
            _target_device(t).type == "cuda"
            for t in (shardings if isinstance(shardings, (tuple, list))
                      else [shardings]))
        self._streams = {}
        self.staging = _StagingRing(self._depth + 1)
        self._q = queue.Queue(maxsize=self._depth)
        self._source_lock = threading.Lock()
        self._closed = threading.Event()
        self._gen = 0
        self._thread = None
        self._done = False
        self._trace_ctx = None

    # -- background side ----------------------------------------------------

    def _start(self):
        if _trace._active and self._trace_ctx is None:
            self._trace_ctx = _trace.current_context()
        t = threading.Thread(target=self._run, args=(self._gen,),
                             name="mx-device-prefetch", daemon=True)
        self._thread = t
        t.start()

    def _stale(self, gen):
        return self._closed.is_set() or gen != self._gen

    def _offer(self, item):
        """Enqueue one item; called with ``_source_lock`` held, so queue
        order is source order even across a stall-recovery handover."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, gen):
        if _trace._active and self._trace_ctx:
            _trace.adopt(self._trace_ctx)
        while not self._stale(gen):
            if _fault._active and _fault.fire("pipeline.prefetch_stall"):
                # wedge BETWEEN batches, holding neither the source lock
                # nor a batch: the replacement thread loses nothing
                while not self._stale(gen):
                    time.sleep(0.02)
                return
            with self._source_lock:
                if self._stale(gen):
                    return
                try:
                    try:
                        item = next(self._source)
                    except StopIteration:
                        self._offer(_DONE)
                        return
                    t0 = time.perf_counter() if _goodput._active else 0.0
                    if _trace._active:
                        with _trace.span("pipeline.h2d",
                                         category="pipeline"):
                            payload = self._put_batch(item)
                    else:
                        payload = self._put_batch(item)
                    if _goodput._active:
                        _goodput.note("h2d", time.perf_counter() - t0)
                except BaseException as exc:  # noqa: BLE001 - to consumer
                    self._offer(_Raise(exc))
                    return
                if not self._offer(payload):
                    return

    def _target_for(self, n):
        sh = self._shardings
        if not isinstance(sh, (tuple, list)):
            return [sh] * n
        return list(sh)[:n] + [None] * max(0, n - len(sh))

    def _put_batch(self, batch):
        copies = []
        if isinstance(batch, (tuple, list)):
            out = type(batch)(
                self._put_leaf(b, t, copies)
                for b, t in zip(batch, self._target_for(len(batch))))
        else:
            out = self._put_leaf(batch, self._target_for(1)[0], copies)
        return _Ready(out, copies)

    def _stream(self, dev):
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(device=dev)
        return s

    def _put_leaf(self, leaf, target, copies):
        from .numpy.multiarray import _wrap
        if isinstance(leaf, (tuple, list)):
            return type(leaf)(self._put_leaf(x, target, copies)
                              for x in leaf)
        t, kind = _leaf_tensor(leaf)
        if t is None:
            return leaf
        dev = _target_device(target)
        if t.device == dev:
            return leaf if kind == "nd" else t
        if dev.type == "cuda" and t.device.type == "cpu":
            src = t
            staged = self.staging.lent(t)
            if not staged and not t.is_pinned():
                src = self.staging.acquire(t.shape, t.dtype)
                src.copy_(t)
                staged = True
            side = self._stream(dev)
            with torch.cuda.stream(side):
                out = torch.empty(t.shape, dtype=t.dtype, device=dev)
                out.copy_(src, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
            if staged:
                self.staging.release(src, ev)
            copies.append((ev, out))
        else:
            out = t.to(dev)
        if _telemetry._active:
            _telemetry.inc("pipeline.h2d_bytes_total", out.nbytes)
        return _wrap(out) if kind == "nd" else out

    # -- consumer side ------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        if self._thread is None:
            self._start()
        t0 = time.perf_counter()
        deadline = t0 + self._stall_timeout
        while True:
            try:
                item = self._q.get(timeout=min(
                    0.2, max(0.001, deadline - time.perf_counter())))
                break
            except queue.Empty:
                if time.perf_counter() >= deadline:
                    self._recover_stall()
                    deadline = time.perf_counter() + self._stall_timeout
        if _telemetry._active:
            _telemetry.observe("pipeline.input_stall_seconds",
                               time.perf_counter() - t0)
            _telemetry.set_gauge("pipeline.inflight_depth", self._q.qsize())
        if item is _DONE:
            self._done = True
            raise StopIteration
        if isinstance(item, _Raise):
            self._done = True
            raise item.exc
        for ev, out in item.copies:
            # the consumer's stream orders after the side-stream copy, and
            # the allocator keeps the tensor until that stream is done
            cur = torch.cuda.current_stream(out.device)
            cur.wait_event(ev)
            out.record_stream(cur)
        if _telemetry._active:
            _telemetry.inc("pipeline.batches_total")
        return item.batch

    def _recover_stall(self):
        """Replace a presumed-wedged prefetch thread: bump the generation
        (the old thread retires at its next check) and hand the source to
        a fresh thread; lossless when the old one was merely slow."""
        _fault.record("pipeline.stall_recovered")
        if _telemetry._active:
            _telemetry.inc("pipeline.stall_recovered_total")
        self._gen += 1
        self._start()

    def close(self):
        """Stop the prefetch thread and close the source iterator (its
        cleanup runs, e.g. the DataLoader's shm bookkeeping). Idempotent."""
        self._closed.set()
        t, self._thread = self._thread, None
        if t is not None:
            while True:  # drain so a put-blocked thread can observe close
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=2.0)
        close_src = getattr(self._source, "close", None)
        if close_src is not None and (t is None or not t.is_alive()):
            try:
                close_src()
            except Exception:  # noqa: BLE001 - best-effort source cleanup
                pass
        self._done = True

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


def prefetch_to_device(batches, target=True, depth=None, stall_timeout=None):
    """Wrap any batch iterator in a :class:`DevicePrefetcher`: ``True``
    the card (raises without one), a device or context that target;
    ``None`` / ``False`` return ``batches`` unchanged."""
    if target is None or target is False:
        return batches
    return DevicePrefetcher(batches,
                            shardings=None if target is True else target,
                            depth=depth, stall_timeout=stall_timeout)
