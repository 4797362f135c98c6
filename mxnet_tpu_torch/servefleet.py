"""mx.servefleet — multi-replica serving control plane.

Counterpart of ``mxnet_tpu/servefleet.py``, with its names, metrics,
spans, fault points and on-disk checkpoint format: N replicas of ONE
model behind a rendezvous-hash router, surviving the three events that
kill a naive deployment:

- **Failover.** Sessions ride consistent-hash (rendezvous / HRW)
  affinity, with the reference's blake2b score, so both packages place a
  session on the same replica. When a replica dies
  (``serve.replica_crash``) or wedges while its lease stays fresh
  (``serve.replica_stall``), only THAT replica's sessions move. Every
  incomplete request re-dispatches to a survivor under its idempotency
  key, re-prefilling from the original prompt: the KV cache died with the
  replica. A late completion racing the re-dispatch (the stalled engine's
  dispatched device work drains AFTER the re-dispatch, with a sync of
  that engine's stream) is suppressed by the completion ledger: every
  accepted request completes exactly once.
- **Rolling weight updates.** A training fleet publishes a checkpoint
  (:func:`publish_checkpoint`: a versioned data directory + an atomic
  symlink swap, never a torn or missing read; ``params.npz`` plus
  ``manifest.json``, so one package's checkpoint loads in the other);
  :meth:`ServeFleet.rolling_update` walks the replicas one at a time:
  drain, swap the weights in place (``update_weights`` copies into the
  tensors the CUDA graphs read), re-``warmup()`` (captures nothing:
  ``post_warmup_compiles`` stays 0), then a greedy canary on pinned
  prompts against the checkpoint's card. A divergent canary or any
  post-warmup capture rolls the replica back and aborts the rollout; the
  group never drops below ``servefleet.min_replicas`` live replicas.
- **SLO-driven scaling.** Sustained error-budget burn past
  ``goodput.burn_threshold`` scales out (unpark first, then build up to
  ``servefleet.max_replicas``); sustained occupancy under
  ``servefleet.occupancy_floor`` drains and parks a replica, never below
  the floor. ``servefleet.scale_patience`` debounces both directions and
  doubles as the cooldown.

On the card a replica holds its weights, graphs, their memory pool and a
KV cache. The reference keeps a dead replica's engine in the group; here
its record stays while its card memory is released once its failover is
done (at once after a crash, after the drain after a stall), so a
crash-and-rebuild cycle holds one engine's memory, not two.

Every replica holds a :class:`~mxnet_tpu_torch.fleet.HealthPlane` lease
when the fleet is built with a ``lease_dir``, so a multi-process drill
detects a SIGKILLed replica by lease expiry alone.

Disabled cost: the only hot-path hook is one module-attribute read in
``ServeEngine.step`` (``if _servefleet._active: note_step(engine)``).
"""
from __future__ import annotations

import collections
import hashlib
import itertools
import json
import os
import time
import weakref

from . import config as _config
from . import fault as _fault
from . import fleet as _fleet
from . import goodput as _goodput
from . import telemetry as _telemetry
from . import trace as _trace
from .base import MXNetError

__all__ = ["ServeFleet", "FleetRequest", "Replica", "rendezvous_route",
           "canary_card", "publish_checkpoint", "load_checkpoint",
           "note_step", "endpoint_report"]

_telemetry.declare_metric(
    "servefleet.replicas_live", "gauge",
    "serving replicas currently live (routable) in the fleet group")
_telemetry.declare_metric(
    "servefleet.requests_total", "counter",
    "requests accepted by the fleet router (each carries an idempotency "
    "key; duplicate submits of the same key are absorbed, not re-run)")
_telemetry.declare_metric(
    "servefleet.completed_total", "counter",
    "fleet requests whose FIRST completion was recorded in the ledger — "
    "exactly one per accepted request, however many replicas raced it")
_telemetry.declare_metric(
    "servefleet.failovers_total", "counter",
    "replicas declared dead by the supervisor, by cause (crash: lease "
    "expiry / serve.replica_crash; stall: no decode progress past "
    "servefleet.stall_deadline with a fresh lease)")
_telemetry.declare_metric(
    "servefleet.redispatched_total", "counter",
    "incomplete requests re-dispatched from a dead replica to a "
    "survivor under their idempotency key (re-prefilled from the "
    "original prompt — the KV died with the replica)")
_telemetry.declare_metric(
    "servefleet.duplicates_suppressed_total", "counter",
    "late completions discarded by the idempotency ledger because the "
    "request already completed elsewhere (a stalled replica's drained "
    "device work racing its own re-dispatch)")
_telemetry.declare_metric(
    "servefleet.rolling_updates_total", "counter",
    "replicas successfully rolled to a new weight generation (drain -> "
    "in-place swap -> re-warmup with zero compiles -> canary parity)")
_telemetry.declare_metric(
    "servefleet.rollbacks_total", "counter",
    "rolling updates auto-rolled back on this replica: greedy canary "
    "diverged from the checkpoint's card, or re-warmup compiled")
_telemetry.declare_metric(
    "servefleet.scale_events_total", "counter",
    "autoscaler actions, by dir (out: sustained SLO burn past "
    "goodput.burn_threshold; in: sustained occupancy under "
    "servefleet.occupancy_floor)")
_telemetry.declare_metric(
    "servefleet.router_moves_total", "counter",
    "sessions whose rendezvous-hash route changed replica (failover or "
    "scaling) — affinity means this stays near zero in steady state")
_telemetry.declare_metric(
    "servefleet.prefix_routed_total", "counter",
    "sessionless requests routed by prompt-prefix fingerprint (hash of "
    "the first serve.prefix_block tokens), steering shared-prefix "
    "traffic to the replica whose radix cache already holds the rows")

#: hot-path gate — ``ServeEngine.step`` reads this one attribute per
#: decode step; False (no fleet constructed) keeps the hook a no-op
_active = False
#: id(engine) -> Replica, the step-progress watch the stall detector
#: reads (see :func:`note_step`)
_watch: dict[int, "Replica"] = {}
#: live fleets, for the /servefleet ops endpoint
_fleets: "weakref.WeakSet[ServeFleet]" = weakref.WeakSet()

CHECKPOINT_FORMAT = "mx.servefleet.checkpoint.v1"


def note_step(engine):
    """Record decode-step progress for the replica hosting ``engine`` —
    called from ``ServeEngine.step`` behind the ``_active`` gate.  This
    timestamp is what separates *stalled* (pending work, no progress
    past ``servefleet.stall_deadline``) from merely idle."""
    rep = _watch.get(id(engine))
    if rep is not None:
        rep.last_step = time.monotonic()
        rep.steps += 1


def _gauge(name, value, **labels):
    if _telemetry._active:
        _telemetry.set_gauge(name, value, **labels)


def _count(name, n=1, **labels):
    if _telemetry._active:
        _telemetry.inc(name, n, **labels)


# ---------------------------------------------------------------------------
# rendezvous (HRW) routing
# ---------------------------------------------------------------------------

def _score(session, rid):
    h = hashlib.blake2b(f"{session}|{rid}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


def rendezvous_route(session, replica_ids):
    """Highest-random-weight (rendezvous) hash: pick the replica with
    the max keyed score.  The property the router needs: when a replica
    leaves, ONLY the sessions it owned re-rank — every other session
    keeps its replica (no modulo reshuffle), so failover moves the
    minimum number of KV-affine sessions.  Deterministic across
    processes (blake2b, no seed) so the multi-process drill's driver
    and any observer agree on placement."""
    ids = list(replica_ids)
    if not ids:
        raise MXNetError("rendezvous_route: no live replicas")
    return max(ids, key=lambda rid: _score(session, rid))


def _route_order(session, replica_ids):
    """All live replicas, best rendezvous score first — the spill order
    when the affine replica rejects with EngineBusy."""
    return sorted(replica_ids, key=lambda rid: _score(session, rid),
                  reverse=True)


# ---------------------------------------------------------------------------
# request + replica records
# ---------------------------------------------------------------------------

class FleetRequest:
    """One accepted request's fleet-level record: the idempotency key,
    the session it routes under, the original prompt (re-dispatch
    re-prefills from it), the current engine-level request, and any
    orphaned engine requests left behind on a dead replica whose
    already-dispatched device work may still complete (the dedupe
    race).  ``tokens`` is None until the FIRST completion lands."""

    __slots__ = ("key", "session", "prompt", "max_new_tokens", "eos_id",
                 "slo_class", "engine_req", "orphans", "replica_id",
                 "redispatches", "tokens", "t_submit", "t_done")

    def __init__(self, key, session, prompt, max_new_tokens, eos_id,
                 slo_class=None):
        self.key = str(key)
        self.session = str(session)
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.slo_class = slo_class
        self.engine_req = None
        self.orphans = []
        self.replica_id = None
        self.redispatches = 0
        self.tokens = None
        self.t_submit = time.monotonic()
        self.t_done = None

    @property
    def done(self):
        return self.tokens is not None

    def __repr__(self):
        state = "done" if self.done else f"replica{self.replica_id}"
        return (f"FleetRequest(key={self.key!r}, session={self.session!r},"
                f" {state}, redispatches={self.redispatches})")


class Replica:
    """One engine + its lease + supervisor-visible state.

    States: ``live`` (routable), ``updating`` (mid rolling update,
    excluded from routing), ``parked`` (drained by scale-in, engine
    kept warm for instant unpark), ``dead`` (failed over, never
    revived — scale-out builds a fresh replica instead)."""

    __slots__ = ("rid", "engine", "plane", "state", "wedged",
                 "last_step", "steps", "generation", "__weakref__")

    def __init__(self, rid, engine, plane=None):
        self.rid = int(rid)
        self.engine = engine
        self.plane = plane
        self.state = "live"
        #: the serve.replica_stall injection wedges the step loop while
        #: the lease keeps renewing — progress stops, liveness doesn't
        self.wedged = False
        self.last_step = time.monotonic()
        self.steps = 0
        self.generation = 0

    def occupancy(self):
        live = sum(1 for s in self.engine._slots if s is not None)
        return live / max(1, self.engine.max_slots)

    def snapshot(self):
        return {"rid": self.rid, "state": self.state,
                "generation": self.generation, "steps": self.steps,
                "wedged": self.wedged,
                "occupancy": round(self.occupancy(), 4),
                "queued": len(self.engine._queue),
                "post_warmup_compiles": self.engine.post_warmup_compiles,
                "prefix_hits": self.engine.prefix_hits}


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

class ServeFleet:
    """N replicas of one model behind a rendezvous-hash router.

    Usage::

        fleet = mx.servefleet.ServeFleet(lambda: build_model(),
                                         replicas=3, eos_id=50256)
        fr = fleet.submit(ids, max_new_tokens=64, session="user-7")
        fleet.run()                     # supervisor tick loop
        fr.tokens                       # exactly-once result
        fleet.rolling_update(new_params, canary=card)
        fleet.close()

    ``model_factory`` builds one model instance per replica (replicas
    must not share parameter state — a rolling update swaps one replica
    at a time).  Engine keyword arguments (``max_slots``, ``buckets``,
    ``eos_id``, ``temperature``, ``quantize``...) pass through to every
    :class:`~mxnet_tpu_torch.serve.engine.ServeEngine`.  With ``lease_dir``
    each replica holds a :class:`~mxnet_tpu_torch.fleet.HealthPlane` lease;
    a lease stale past ``fleet.lease_timeout`` is a detected crash.
    """

    def __init__(self, model_factory, replicas=2, min_replicas=None,
                 max_replicas=None, lease_dir=None, warmup=True,
                 **engine_kwargs):
        if not callable(model_factory):
            raise MXNetError("ServeFleet needs a model_factory callable "
                             "(one fresh model per replica)")
        replicas = int(replicas)
        if replicas < 1:
            raise MXNetError("ServeFleet needs at least one replica")
        self._model_factory = model_factory
        self._engine_kwargs = dict(engine_kwargs)
        self._lease_dir = lease_dir
        self._warmup = bool(warmup)
        self.min_replicas = int(min_replicas if min_replicas is not None
                                else _config.get("servefleet.min_replicas"))
        cap = int(max_replicas if max_replicas is not None
                  else _config.get("servefleet.max_replicas"))
        self.max_replicas = cap if cap > 0 else replicas
        if self.min_replicas > replicas:
            raise MXNetError(
                f"servefleet.min_replicas={self.min_replicas} exceeds the "
                f"constructed replica count {replicas}")
        self._replicas: dict[int, Replica] = {}
        #: the exactly-once ledger, split so its cost stays bounded on a
        #: long-running fleet: in-flight requests (plus done ones still
        #: owed a duplicate-suppression sweep) live in ``_inflight``;
        #: settled requests move to ``_completed``, an LRU capped at
        #: ``servefleet.ledger_retain`` keys kept to absorb duplicate
        #: client submits.  Lifetime totals ride separate counters so
        #: :meth:`report` never needs the full history.
        self._inflight: dict[str, FleetRequest] = {}
        self._completed: "collections.OrderedDict[str, FleetRequest]" = \
            collections.OrderedDict()
        self._accepted_total = 0
        self._completed_total = 0
        self._redispatched_total = 0
        self._session_map: dict[str, int] = {}
        self._overflow = collections.deque()
        self._next_rid = 0
        self._next_key = 0
        self._tick = 0
        self._generation = 0
        self._current_params = None
        # autoscaler debounce/cooldown state
        self._burn_ticks = 0
        self._idle_ticks = 0
        self._cooldown = 0
        self._scale_events = {"out": 0, "in": 0}
        for _ in range(replicas):
            self._build_replica()
        _fleets.add(self)
        self._sync_gauges()

    # -- replica lifecycle ----------------------------------------------

    def _build_replica(self):
        from .serve.engine import ServeEngine
        global _active
        rid = self._next_rid
        self._next_rid += 1
        eng = ServeEngine(self._model_factory(), **self._engine_kwargs)
        if self._current_params is not None:
            # a scale-out after a rolling update must serve the CURRENT
            # generation, not whatever the factory initialized
            eng.update_weights(self._current_params)
        if self._warmup:
            eng.warmup()
        plane = None
        if self._lease_dir:
            plane = _fleet.HealthPlane(
                rank=rid, nprocs=self.max_replicas,
                lease_dir=self._lease_dir).start()
        rep = Replica(rid, eng, plane)
        rep.generation = self._generation
        self._replicas[rid] = rep
        _watch[id(eng)] = rep
        _active = True
        return rep

    def _live(self):
        return [r for r in self._replicas.values() if r.state == "live"]

    def _parked(self):
        return [r for r in self._replicas.values() if r.state == "parked"]

    def _sync_gauges(self):
        _gauge("servefleet.replicas_live", len(self._live()))

    # -- routing + submission -------------------------------------------

    def submit(self, prompt, max_new_tokens=32, session=None, key=None,
               eos_id="engine", slo_class=None):
        """Accept one request under an idempotency ``key`` (generated
        when omitted) and route it by rendezvous hash of ``session``.
        A sessionless request routes by *prompt-prefix fingerprint* —
        the blake2b hash of its first ``serve.prefix_block`` tokens —
        so shared-prefix traffic converges on the replica whose radix
        prefix cache already holds those KV rows.  Re-submitting an
        accepted key returns the SAME :class:`FleetRequest` — the
        idempotent accept that makes client retries safe.  Raises
        :class:`~mxnet_tpu_torch.serve.engine.EngineBusy` (with the max
        ``retry_after_hint`` across replicas) only when EVERY live
        replica rejects.  ``slo_class`` rides through to the engine's
        priority admission (serve.slo_classes)."""
        if key is None:
            key = f"req-{self._next_key}"
            self._next_key += 1
        key = str(key)
        if key in self._inflight:
            return self._inflight[key]
        if key in self._completed:
            return self._completed[key]
        import numpy as onp
        prompt = [int(t) for t in onp.asarray(prompt).reshape(-1)]
        if session is None:
            block = max(1, int(_config.get("serve.prefix_block")))
            h = hashlib.blake2b(
                ",".join(str(t) for t in prompt[:block]).encode(),
                digest_size=8)
            session = f"px-{h.hexdigest()}"
            _count("servefleet.prefix_routed_total")
        eos = (self._engine_kwargs.get("eos_id")
               if eos_id == "engine" else eos_id)
        fr = FleetRequest(key, session, prompt, max_new_tokens, eos,
                          slo_class=slo_class)
        self._dispatch(fr, queue_on_busy=False)
        self._inflight[key] = fr
        self._accepted_total += 1
        _count("servefleet.requests_total")
        return fr

    def _dispatch(self, fr, queue_on_busy=True):
        """Route ``fr`` to the best live replica (rendezvous order,
        spilling on EngineBusy).  With ``queue_on_busy`` an all-busy
        fleet parks the request in the overflow queue (retried every
        tick) instead of raising — a failover re-dispatch must never
        drop an accepted request."""
        from .serve.engine import EngineBusy
        live = self._live()
        if not live:
            # the last replica just died: queueing keeps the "never
            # drop an accepted request" promise — the supervisor tick
            # rebuilds capacity and retries the overflow queue
            if queue_on_busy:
                self._overflow.append(fr)
                return False
            raise MXNetError("servefleet: no live replicas "
                             f"(min_replicas={self.min_replicas})")
        last = None
        for rid in _route_order(fr.session, [r.rid for r in live]):
            rep = self._replicas[rid]
            try:
                req = rep.engine.submit(fr.prompt, fr.max_new_tokens,
                                        eos_id=fr.eos_id,
                                        slo_class=fr.slo_class)
            except EngineBusy as e:
                last = e if last is None or \
                    e.retry_after_hint > last.retry_after_hint else last
                continue
            fr.engine_req = req
            fr.replica_id = rid
            prev = self._session_map.get(fr.session)
            if prev is not None and prev != rid:
                _count("servefleet.router_moves_total")
            self._session_map[fr.session] = rid
            return True
        if queue_on_busy:
            self._overflow.append(fr)
            return False
        raise last

    # -- the supervisor tick --------------------------------------------

    def step(self):
        """One supervisor tick: probe the chaos points, retry overflow,
        advance every live replica one engine step, detect stalls and
        stale leases, collect completions into the ledger, run the
        autoscaler.  The fleet analog of ``ServeEngine.step`` — online
        callers own this loop."""
        self._tick += 1
        now = time.monotonic()
        if _fault._active:
            if _fault.fire("serve.replica_crash", step=self._tick):
                victim = self._victim()
                if victim is not None:
                    self._fail(victim, "crash")
            if _fault.fire("serve.replica_stall", step=self._tick):
                victim = self._victim()
                if victim is not None:
                    victim.wedged = True
                    _fault.record("servefleet.replica_wedged")
        self._check_leases()
        if not self._live() and self.pending:
            # every replica is dead but accepted work is still owed:
            # dead replicas are never revived — unpark or build a fresh
            # one so the overflow queue can drain
            self._scale_out(reason="fleet_dead")
        for _ in range(len(self._overflow)):
            fr = self._overflow.popleft()
            if not fr.done:
                self._dispatch(fr)
        for rep in self._live():
            if rep.wedged:
                continue  # the stall drill: lease fresh, loop frozen
            if rep.engine.pending:
                rep.engine.step()  # note_step() stamps rep.last_step
            else:
                rep.last_step = now  # idle is not a stall
        deadline = float(_config.get("servefleet.stall_deadline"))
        for rep in list(self._live()):
            if rep.engine.pending and \
                    time.monotonic() - rep.last_step > deadline:
                self._fail(rep, "stall")
        self._collect()
        self._autoscale()
        return self

    @property
    def pending(self):
        return bool(self._overflow) or \
            any(not fr.done for fr in self._inflight.values())

    def run(self, max_ticks=None, tick_interval=0.0):
        """Tick until every accepted request completed (or ``max_ticks``
        elapsed).  Completion is ledger-level: a request survives its
        replica dying mid-stream.  ``tick_interval`` paces the loop
        (seconds of sleep per tick) — wall-clock detectors like the
        ``servefleet.stall_deadline`` watchdog need real time to pass,
        not just iterations."""
        ticks = 0
        while self.pending:
            self.step()
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
            if tick_interval > 0:
                time.sleep(tick_interval)
        return self

    def _victim(self):
        """Pick the chaos victim deterministically: the live replica
        carrying the most work (fails the most interesting one)."""
        live = self._live()
        if not live:
            return None
        return max(live, key=lambda r: (
            sum(1 for s in r.engine._slots if s is not None)
            + len(r.engine._queue), -r.rid))

    # -- failover --------------------------------------------------------

    def _check_leases(self):
        """A live replica whose lease file is stale past the plane
        timeout is a detected crash — the multi-host analog of
        ``fleet.host_loss``, driven by the same file-backed lease."""
        if not self._lease_dir:
            return
        timeout = float(_config.get("fleet.lease_timeout"))
        for rep in list(self._live()):
            if rep.plane is not None:
                timeout = rep.plane.timeout
            path = os.path.join(self._lease_dir,
                                f"host-{rep.rid}.lease")
            try:
                with open(path) as f:
                    payload = json.load(f)
            except (OSError, ValueError):
                continue  # never published / torn mid-write: not proof
            if time.time() - float(payload.get("time", 0)) > timeout:
                _count("fleet.lease_expiries_total")
                self._fail(rep, "crash")

    def _fail(self, rep, cause):
        """Declare ``rep`` dead and make its work whole: re-dispatch
        every incomplete request to a survivor under its idempotency
        key, THEN (stall only) drain the dead engine's already-
        dispatched device work — deliberately after, so a late orphan
        completion races its own re-dispatch and the ledger's dedupe is
        exercised for real, not just in theory.  A crash drops the
        window outright: the KV and in-flight emits died with the
        host."""
        if rep.state == "dead":
            return
        with _trace.span("servefleet.failover", category="servefleet",
                         replica=rep.rid, cause=cause):
            rep.state = "dead"
            rep.wedged = False
            _count("servefleet.failovers_total", cause=cause)
            _fault.record(f"servefleet.failover_{cause}")
            if rep.plane is not None:
                rep.plane.stop()
            victims = [fr for fr in self._inflight.values()
                       if not fr.done and fr.replica_id == rep.rid]
            for fr in victims:
                orphan = fr.engine_req
                fr.engine_req = None
                if cause == "stall" and orphan is not None:
                    fr.orphans.append(orphan)
                fr.redispatches += 1
                self._redispatched_total += 1
                self._dispatch(fr)
                _count("servefleet.redispatched_total")
            if not self._live():
                # the whole group is down; victims sit safely in the
                # overflow queue and the next tick rebuilds capacity —
                # record the condition once rather than raising out of
                # the victims loop with failover half-done
                _fault.record("servefleet.fleet_dead")
            if cause == "stall":
                # flush what the wedged engine had already dispatched (the
                # fetch waits for its stream): orphans may complete here
                # and beat their re-dispatch
                rep.engine.drain()
            self._collect()
            # anything a dead-and-drained replica didn't finish never
            # will — stop watching those orphans
            for fr in victims:
                fr.orphans = [o for o in fr.orphans if o.finished]
            # its failover done, the dead engine's graphs, pool, cache and
            # weights give their card memory back; the record stays
            rep.engine._release()
        self._sync_gauges()

    # -- the exactly-once ledger ----------------------------------------

    def _record(self, fr, ereq):
        if fr.tokens is None:
            fr.tokens = list(ereq.generated)
            fr.t_done = time.monotonic()
            self._completed_total += 1
            _count("servefleet.completed_total")
        else:
            _count("servefleet.duplicates_suppressed_total")

    def _collect(self):
        """Sweep engine-level completions into the fleet ledger.  First
        finish wins; every later finish of the same key (an orphan or a
        raced re-dispatch) is counted suppressed and discarded.  A
        request with no engine-level copy left in flight settles into
        the capped completed LRU (``servefleet.ledger_retain``) so the
        per-tick sweep only ever walks genuinely open work."""
        retain = max(0, int(_config.get("servefleet.ledger_retain")))
        settled = []
        for fr in self._inflight.values():
            req = fr.engine_req
            if req is not None and req.finished:
                self._record(fr, req)
                fr.engine_req = None
            if fr.orphans:
                still = []
                for o in fr.orphans:
                    if o.finished:
                        self._record(fr, o)
                    else:
                        still.append(o)
                fr.orphans = still
            # done with no copy still running anywhere: nothing left to
            # suppress, safe to leave the hot sweep
            if fr.done and fr.engine_req is None and not fr.orphans:
                settled.append(fr.key)
        for key in settled:
            self._completed[key] = self._inflight.pop(key)
            self._completed.move_to_end(key)
        while len(self._completed) > retain:
            self._completed.popitem(last=False)

    # -- rolling weight updates -----------------------------------------

    def rolling_update(self, params, canary=None):
        """Roll every live replica to ``params`` (a flat
        ``{name: array}`` tree, e.g. a training fleet's published
        checkpoint) one replica at a time, never dropping the group
        below ``servefleet.min_replicas`` live replicas.

        Per replica, inside a goodput ``rollover`` bracket: mark
        ``updating`` (router excludes it), ``stop(drain=True)`` (every
        accepted request on it finishes under the OLD weights —
        generations never mix inside one request), swap weights in
        place, ``resume()`` + ``warmup()`` (every graph already captured:
        zero captures), then replay the ``canary`` card's pinned
        prompts greedily and compare token-for-token.  Divergence or
        any post-warmup capture restores the old weights, counts
        ``servefleet.rollbacks_total`` and ABORTS the rollout, so a bad
        checkpoint stops at one replica and the fleet keeps serving the
        old generation everywhere.

        ``canary`` is a card from :func:`canary_card` /
        :func:`publish_checkpoint`: ``{"prompts": [...], "expected":
        [[tok, ...], ...], "tokens": n}``.  Returns a report dict;
        ``report["rolled_back"]`` tells the publisher its checkpoint
        was rejected."""
        params = dict(params)
        if canary is not None:
            # validate the card and the engines UP FRONT, before any
            # replica is drained or its weights swapped: failing later
            # (inside _canary_check) would strand one replica live on
            # un-canaried new weights with no rollback
            if not isinstance(canary, dict) or \
                    "prompts" not in canary or "expected" not in canary:
                raise MXNetError(
                    "rolling_update canary must be a canary_card dict "
                    "with 'prompts' and 'expected'")
            hot = [r.rid for r in self._replicas.values()
                   if r.state in ("live", "parked", "updating")
                   and r.engine.temperature != 0]
            if hot:
                raise MXNetError(
                    "canary parity requires greedy decoding "
                    "(temperature=0); build the fleet engines greedy "
                    f"or pass canary=None (sampling replicas: {hot})")
        target = self._generation + 1
        updated, report = [], None
        # re-derive the worklist every iteration instead of snapshotting
        # it: a replica added or unparked mid-rollout (the floor-guard
        # _scale_out below) comes up on the OLD generation and must be
        # rolled too — a successful rollout leaves EVERY live replica on
        # the new generation, never a silent mix
        while report is None:
            stale = [r for r in self._live() if r.generation < target]
            if not stale:
                break
            rep = stale[0]
            if len(self._live()) - 1 < self.min_replicas:
                # taking this replica out for the update would breach
                # the floor: bring capacity up first or refuse
                if self._scale_out(reason="rolling_update") is None:
                    raise MXNetError(
                        "rolling_update would drop the group below "
                        f"servefleet.min_replicas={self.min_replicas} "
                        "and no scale-out capacity remains")
            tok = _goodput.begin("rollover") if _goodput._active else None
            with _trace.span("servefleet.rolling_update",
                             category="servefleet", replica=rep.rid,
                             generation=self._generation + 1):
                try:
                    rep.state = "updating"
                    self._sync_gauges()
                    rep.engine.stop(drain=True)
                    self._collect()
                    before = rep.engine.post_warmup_compiles
                    old = rep.engine.update_weights(params)
                    rep.engine.resume()
                    rep.engine.warmup()
                    ok = rep.engine.post_warmup_compiles == before
                    reason = None if ok else "post_warmup_compiles"
                    if ok and canary is not None:
                        ok, reason = self._canary_check(rep, canary)
                    if not ok:
                        rep.engine.restore_weights(old)
                        _count("servefleet.rollbacks_total")
                        _fault.record("servefleet.rollback")
                        report = {"updated": updated, "rolled_back": True,
                                  "replica": rep.rid, "reason": reason}
                        break
                    rep.generation = target
                    _count("servefleet.rolling_updates_total")
                    updated.append(rep.rid)
                finally:
                    rep.state = "live" if rep.state == "updating" \
                        else rep.state
                    self._sync_gauges()
                    _goodput.end(tok)
        if report is None:
            self._generation = target
            self._current_params = params
            report = {"updated": updated, "rolled_back": False,
                      "generation": self._generation}
        return report

    def _canary_check(self, rep, canary):
        """Greedy parity on the pinned prompts: the new weights must
        reproduce the checkpoint's canary card token-for-token.

        Never raises: ``rolling_update`` validated the card and engine
        temperatures before touching any replica, so a failure here is
        a verdict — returned as ``(False, reason)`` and routed through
        the normal restore_weights rollback path, never an exception
        that would strand the replica on un-canaried weights."""
        if rep.engine.temperature != 0:
            return False, (
                f"replica {rep.rid} engine is sampling "
                "(temperature != 0); canary parity requires greedy "
                "decoding")
        n = int(canary.get("tokens")
                or _config.get("servefleet.canary_tokens"))
        for prompt, expected in zip(canary["prompts"],
                                    canary["expected"]):
            req = rep.engine.submit(prompt, max_new_tokens=n)
            rep.engine.run()
            if list(req.generated) != list(expected):
                return False, (
                    f"canary diverged on replica {rep.rid}: "
                    f"{list(req.generated)} != {list(expected)}")
        return True, None

    # -- SLO-driven scaling ---------------------------------------------

    def _autoscale(self):
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        patience = max(1, int(_config.get("servefleet.scale_patience")))
        thresh = float(_config.get("goodput.burn_threshold"))
        live = self._live()
        if not live:
            return
        burns = [max(r.engine.slo_burn().values() or [0.0])
                 for r in live]
        if max(burns) > thresh:
            self._burn_ticks += 1
        else:
            self._burn_ticks = 0
        if self._burn_ticks >= patience:
            self._burn_ticks = 0
            if self._scale_out(reason="slo_burn") is not None:
                self._cooldown = patience
            return
        floor = float(_config.get("servefleet.occupancy_floor"))
        occ = sum(r.occupancy() for r in live) / len(live)
        if occ < floor and len(live) > self.min_replicas \
                and not self.pending:
            self._idle_ticks += 1
        else:
            self._idle_ticks = 0
        if self._idle_ticks >= patience:
            self._idle_ticks = 0
            if self._scale_in() is not None:
                self._cooldown = patience

    def _scale_out(self, reason="slo_burn"):
        """Add capacity: unpark a drained replica (instant — its graphs
        are still captured) before building a fresh one, bounded by
        ``servefleet.max_replicas``.  Returns the replica or None."""
        with _trace.span("servefleet.scale", category="servefleet",
                         dir="out", reason=reason):
            parked = self._parked()
            if parked:
                rep = parked[0]
                rep.engine.resume()
                if rep.generation != self._generation and \
                        self._current_params is not None:
                    # parked through a completed rolling update: bring
                    # it onto the current generation before it takes
                    # traffic (mid-rollout unparks keep the old weights
                    # and are rolled by the update's own worklist)
                    rep.engine.update_weights(self._current_params)
                    rep.generation = self._generation
                if rep.plane is not None:
                    rep.plane.start()
                rep.state = "live"
                rep.last_step = time.monotonic()
            elif len(self._live()) < self.max_replicas:
                rep = self._build_replica()
            else:
                return None
            _count("servefleet.scale_events_total", dir="out")
            self._scale_events["out"] += 1
            self._sync_gauges()
            return rep

    def _scale_in(self):
        """Drain and park the least-occupied live replica (engine and
        captured graphs kept; lease withdrawn).  Refuses below
        ``servefleet.min_replicas``.  Returns the replica or None."""
        live = self._live()
        if len(live) <= self.min_replicas:
            return None
        with _trace.span("servefleet.scale", category="servefleet",
                         dir="in"):
            rep = min(live, key=lambda r: (r.occupancy(), r.rid))
            rep.state = "parked"
            rep.engine.stop(drain=True)
            self._collect()
            if rep.plane is not None:
                rep.plane.stop()
            _count("servefleet.scale_events_total", dir="in")
            self._scale_events["in"] += 1
            self._sync_gauges()
            return rep

    # -- reporting / shutdown -------------------------------------------

    def report(self):
        return {
            "replicas": [r.snapshot() for r in self._replicas.values()],
            "live": len(self._live()),
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "generation": self._generation,
            "requests": self._accepted_total,
            "completed": self._completed_total,
            "pending": self._accepted_total - self._completed_total,
            "overflow": len(self._overflow),
            "redispatched": self._redispatched_total,
            "ledger_retained": len(self._completed),
            "sessions": len(self._session_map),
            "scale_events": dict(self._scale_events),
            "ticks": self._tick,
        }

    def close(self, drain=False):
        """Tear the group down: stop every lease, stop every engine
        (``drain=True`` finishes accepted work first), detach the
        step-progress watch.  The module hot-path gate drops back to
        False when the last fleet closes."""
        global _active
        if drain:
            self.run()
        for rep in self._replicas.values():
            if rep.plane is not None:
                rep.plane.stop()
            if rep.state != "dead":
                try:
                    rep.engine.stop(drain=False)
                except Exception:  # noqa: BLE001 - teardown is best-effort
                    pass
            _watch.pop(id(rep.engine), None)
        self._replicas.clear()
        _fleets.discard(self)
        _active = bool(_watch)
        _gauge("servefleet.replicas_live", 0)
        return self


# ---------------------------------------------------------------------------
# canary cards + staged checkpoint publish
# ---------------------------------------------------------------------------

def canary_card(model_or_engine, prompts, tokens=None, **engine_kwargs):
    """Compute the greedy-parity card a rolling update validates
    against: for each pinned prompt, the exact token ids the published
    weights generate greedily.  The publisher runs this ONCE per
    checkpoint (a scratch engine's captures are warmup captures, not
    serving-path ones) and ships the card in the checkpoint
    manifest."""
    from .serve.engine import ServeEngine
    n = int(tokens if tokens is not None
            else _config.get("servefleet.canary_tokens"))
    eng = model_or_engine
    if not isinstance(eng, ServeEngine):
        engine_kwargs.setdefault("temperature", 0.0)
        eng = ServeEngine(model_or_engine, **engine_kwargs)
    if eng.temperature != 0:
        raise MXNetError("canary_card requires greedy decoding "
                         "(temperature=0)")
    expected = []
    for prompt in prompts:
        req = eng.submit(prompt, max_new_tokens=n)
        eng.run()
        expected.append([int(t) for t in req.generated])
    return {"prompts": [list(map(int, p)) for p in prompts],
            "tokens": n, "expected": expected}


#: per-process publish counter — makes every versioned data directory
#: name unique (pid disambiguates across processes)
_publish_seq = itertools.count()


def publish_checkpoint(path, params, canary=None, step=None):
    """Staged checkpoint publish for serving fleets: write the flat param
    tree (tensors or arrays; bf16 widened to float32) + manifest into a
    versioned data directory (``<path>.g<pid>.<seq>``), fsync, then
    atomically swap a symlink at ``path`` over it (``os.replace`` of a
    prepared link is ONE rename): a replica polling ``path`` resolves
    either the previous complete checkpoint or the new complete one;
    ``path`` is never missing and never a torn directory, however the
    reader races the publisher. The superseded data directory is removed
    after the swap. ``canary`` (a :func:`canary_card` dict) rides in the
    manifest so every consumer validates against the SAME pinned outputs.
    The format is the reference's: a checkpoint published by either
    package loads in the other."""
    import shutil

    import numpy as onp
    import torch

    def host(v):
        v = getattr(v, "_data", v)   # an mx.np array's tensor
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                v = v.float()
            return v.numpy()
        return onp.asarray(v)

    path = str(path)
    data = f"{path}.g{os.getpid()}.{next(_publish_seq)}"
    os.makedirs(data, exist_ok=True)
    arrays = {k: host(v) for k, v in dict(params).items()}
    onp.savez(os.path.join(data, "params.npz"), **arrays)
    manifest = {"format": CHECKPOINT_FORMAT, "step": step,
                "params": sorted(arrays), "canary": canary}
    mpath = os.path.join(data, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    # prepare the link first, then swap: the replace is the publish
    lnk = f"{path}.lnk.{os.getpid()}"
    if os.path.lexists(lnk):
        os.remove(lnk)
    os.symlink(os.path.basename(data), lnk)
    prev = None
    if os.path.islink(path):
        prev = os.path.join(os.path.dirname(path) or ".",
                            os.readlink(path))
    elif os.path.isdir(path):
        # legacy in-place directory (pre-symlink layout): a link can't be
        # renamed over a real directory, so move it aside first — the only
        # case with a (syscall-wide) missing window, which
        # load_checkpoint's bounded retry absorbs
        prev = f"{path}.g{os.getpid()}.legacy{next(_publish_seq)}"
        os.rename(path, prev)
    os.replace(lnk, path)
    if prev is not None:
        shutil.rmtree(prev, ignore_errors=True)
    return path


def load_checkpoint(path):
    """-> ``(params, canary)`` from a :func:`publish_checkpoint` directory
    (either package's), ``params`` as CPU torch tensors by name
    (``update_weights`` moves them to the engine's device). Raises
    :class:`MXNetError` on a missing or wrong-format manifest (a torn
    publish can never look valid: the link swap is atomic, so a readable
    manifest implies complete params). A transiently missing manifest is
    retried briefly before failing: the one racy window left is a
    publisher migrating a legacy pre-symlink checkpoint directory."""
    import numpy as onp
    import torch
    mpath = os.path.join(str(path), "manifest.json")
    manifest, err = None, None
    for _ in range(3):
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            break
        except FileNotFoundError as e:
            err = e
            time.sleep(0.01)
        except (OSError, ValueError) as e:
            raise MXNetError(
                f"unreadable checkpoint manifest {mpath}: {e}") from e
    if manifest is None:
        raise MXNetError(
            f"unreadable checkpoint manifest {mpath}: {err}") from err
    if manifest.get("format") != CHECKPOINT_FORMAT:
        raise MXNetError(
            f"checkpoint {path} has format {manifest.get('format')!r}, "
            f"expected {CHECKPOINT_FORMAT!r}")
    with onp.load(os.path.join(str(path), "params.npz")) as data:
        params = {k: torch.from_numpy(onp.array(data[k]))
                  for k in data.files}
    return params, manifest.get("canary")


def endpoint_report():
    """The /servefleet ops endpoint payload: one report per live fleet
    group in this process."""
    return {"active": _active,
            "fleets": [f.report() for f in list(_fleets)]}
