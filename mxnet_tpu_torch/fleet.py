"""mx.fleet — health-plane-driven elastic mesh degradation.

Counterpart of ``mxnet_tpu/fleet.py``, with its names, ``fleet.*``
metrics, ``fleet``-category trace spans and fault points:

- :class:`HealthPlane` — per-host heartbeat lease (``host-<rank>.lease``
  files in a directory every host reaches, mirrored best-effort into the
  default ``torch.distributed`` store when a process group is up; the
  files stay authoritative), a step-deadline watchdog that tells *slow*
  (straggler gauge) from *wedged* (a structured
  :class:`~mxnet_tpu_torch.resilience.WorkerLost`), the ``fleet``
  /healthz provider, and the insight / blackbox / goodput snapshots on
  the heartbeat's cadence.
- :func:`plan_layout` — the best :class:`MeshConfig` over the surviving
  devices (``mesh_factorizations``): keep tp and pp, shrink dp, keep sp,
  park below the ``fleet.min_dp`` floor.
- :class:`FleetSupervisor` — the degrade / re-expand loop around one
  :class:`~mxnet_tpu_torch.parallel.ShardedTrainStep`: on a host loss it
  re-plans, ``rebuild``s the step around the new layout and restores the
  last *valid* bundle bit for bit (``TrainState.load_latest_valid``);
  when the host returns it re-expands at the next checkpoint boundary.

The reference runs ONE supervisor over the devices of one process. The
port runs one on every rank of a ``torch.distributed`` world (host ``h``
is ranks ``h * k .. h * k + k - 1`` of the target layout's ``n_hosts *
k``), so every transition is a collective decision:

- Every rank takes the same victim: the one the reference's controller
  (host 0) takes. ``fleet.host_loss`` fires on the same step everywhere
  and loses the highest live host other than 0; a loss one rank's health
  plane sees is agreed over the world (a max all-reduce of the hosts seen
  lost, each probe) before anyone acts on it.
- ``make_mesh`` lays every layout on ranks ``0 .. size - 1``, so the layout
  after a loss must lie on live hosts only: the survivors of losing the
  highest host (the reference drill's case). Losing host 0, or a host
  whose ranks the new layout would need, raises :class:`MXNetError`; no
  rank ever computes on a host marked lost.
- The lost host's ranks are stranded by the smaller layout
  (``ShardedTrainStep.stranded``): they take part in every ``rebuild``'s
  group creation (collective over the world), step and save nothing, and
  read the step counter of the same bundle the layout restores, so the
  re-expand happens on every rank at once.
- ``TrainState.save`` of the step is collective over the layout's ranks;
  rank 0 writes. A world barrier precedes every restore, so the newest
  bundle is on disk before any rank reads it.
- A real SIGKILL of a gloo rank breaks every group that holds it, and no
  world is re-formed (the reference has no cross-process degrade either):
  the multi-process drill ends at the ``WorkerLost`` of an expired lease.
"""
from __future__ import annotations

import json
import os
import threading
import time

from . import blackbox as _blackbox
from . import config as _config
from . import fault as _fault
from . import goodput as _goodput
from . import insight as _insight
from . import resilience as _resilience
from . import telemetry as _telemetry
from . import trace as _trace
from .base import MXNetError
from .parallel.mesh import MeshConfig, _world, mesh_factorizations

__all__ = ["HealthPlane", "FleetSupervisor", "plan_layout"]

_telemetry.declare_metric(
    "fleet.peers_expected", "gauge",
    "hosts the fleet supervisor expects in the mesh at full strength")
_telemetry.declare_metric(
    "fleet.peers_alive", "gauge",
    "hosts currently holding a fresh heartbeat lease (or assumed alive "
    "in single-process drills)")
_telemetry.declare_metric(
    "fleet.stragglers", "gauge",
    "hosts past fleet.slow_fraction of the step deadline but still "
    "making progress — slow, not wedged")
_telemetry.declare_metric(
    "fleet.parked", "gauge",
    "1 while the supervisor is parked: too few devices survive to "
    "satisfy fleet.min_dp, so it waits for hosts instead of thrashing")
_telemetry.declare_metric(
    "fleet.dp_size", "gauge",
    "dp extent of the layout currently training (shrinks on degrade, "
    "returns to the target on re-expand)")
_telemetry.declare_metric(
    "fleet.degrades_total", "counter",
    "elastic degrades: host loss -> re-planned smaller layout -> "
    "bitwise bundle restore -> training continues")
_telemetry.declare_metric(
    "fleet.reexpands_total", "counter",
    "re-expansions back to the target layout after lost hosts rejoined "
    "(applied at a checkpoint boundary)")
_telemetry.declare_metric(
    "fleet.heartbeats_total", "counter",
    "heartbeat lease renewals published by this host")
_telemetry.declare_metric(
    "fleet.lease_renew_failures_total", "counter",
    "failed attempts to renew this host's own lease (fleet.lease_lost "
    "injection or an unreachable lease store)")
_telemetry.declare_metric(
    "fleet.lease_expiries_total", "counter",
    "peer leases observed stale past fleet.lease_timeout — each one is "
    "a detected host loss")


def _gauge(name, value):
    if _telemetry._active:
        _telemetry.set_gauge(name, value)


def _count(name, n=1, **labels):
    if _telemetry._active:
        _telemetry.inc(name, n, **labels)


# ---------------------------------------------------------------------------
# layout re-planning
# ---------------------------------------------------------------------------

def plan_layout(current, n_devices, min_dp=None):
    """Pick the best :class:`MeshConfig` over ``n_devices`` surviving
    devices, derived from the ``current`` (target) layout.

    Preference order (lexicographic): keep BOTH tp and pp, then keep tp
    (its sharding divides the weight matrices the model was sized for),
    then keep pp, then maximize dp. The sp extent is always preserved —
    ring-attention geometry is part of the model's math, not capacity.
    Returns ``None`` (park) when no exact-cover factorization exists or
    the best one falls below the ``fleet.min_dp`` floor.
    """
    if min_dp is None:
        min_dp = _config.get("fleet.min_dp")
    candidates = [c for c in mesh_factorizations(n_devices,
                                                 max_sp=current.sp)
                  if c.sp == current.sp]
    if not candidates:
        return None
    best = max(candidates, key=lambda c: (
        c.tp == current.tp and c.pp == current.pp,
        c.tp == current.tp,
        c.pp == current.pp,
        c.dp))
    if best.dp < max(1, int(min_dp)):
        return None
    return best


# ---------------------------------------------------------------------------
# health plane
# ---------------------------------------------------------------------------

class HealthPlane:
    """Per-host heartbeat lease + step-deadline watchdog.

    Leases are JSON files ``host-<rank>.lease`` in ``fleet.lease_dir`` (a
    directory every host can reach; the multi-process tests point it at a
    temporary directory), renewed every ``fleet.lease_interval`` seconds
    by :meth:`beat` (or the :meth:`start` daemon thread). While a
    ``torch.distributed`` group is up, each renewal is also mirrored into
    its default store best-effort; the file store stays authoritative, so
    the plane works with no process group at all.

    :meth:`check_peers` classifies every peer:

    - lease stale past ``fleet.lease_timeout`` -> the host is LOST:
      ``fleet.lease_expiries_total`` ticks and a structured
      :class:`~mxnet_tpu_torch.resilience.WorkerLost` (``op="lease"``)
      raises.
    - lease fresh but its step counter stuck past ``fleet.step_deadline``
      seconds -> WEDGED: ``WorkerLost(op="step_deadline")``.
    - step stuck past ``fleet.slow_fraction`` of the deadline -> SLOW:
      the ``fleet.stragglers`` gauge rises, nothing is killed.

    The plane registers itself as the ``fleet`` /healthz provider: the
    ops endpoint turns red (503) when this host's own renewals fail, its
    local step loop is past the deadline, or a peer lease is stale.
    """

    def __init__(self, rank=0, nprocs=1, lease_dir=None, interval=None,
                 timeout=None):
        self.rank = int(rank)
        self.nprocs = int(nprocs)
        self.lease_dir = (lease_dir if lease_dir is not None
                          else _config.get("fleet.lease_dir"))
        self.interval = (float(interval) if interval is not None
                         else _config.get("fleet.lease_interval"))
        self.timeout = (float(timeout) if timeout is not None
                        else _config.get("fleet.lease_timeout"))
        self._step = 0
        self._step_mono = time.monotonic()
        self._renew_failing = False
        self._seen: set[int] = set()
        #: rank -> (last observed step, monotonic time it last advanced)
        self._peer_progress: dict[int, tuple[int, float]] = {}
        self._stragglers: set[int] = set()
        self._stop = threading.Event()
        self._thread = None
        self._thread_lock = threading.Lock()

    # -- lease publication ----------------------------------------------

    def _lease_path(self, rank):
        return os.path.join(self.lease_dir, f"host-{int(rank)}.lease")

    def beat(self, step=None):
        """Publish one lease renewal. Returns True on success; a failed
        renewal (the ``fleet.lease_lost`` injection, or an unreachable
        store) is counted and flips this host's /healthz check red while
        the heartbeat keeps retrying."""
        if step is not None:
            self.note_step(step)
        payload = {"rank": self.rank, "pid": os.getpid(),
                   "step": int(self._step), "time": time.time()}
        if _fault._active and _fault.fire("fleet.lease_lost", step=step):
            self._renew_failing = True
            _count("fleet.lease_renew_failures_total")
            _fault.record("fleet.lease_renew_failure")
            return False
        try:
            if self.lease_dir:
                os.makedirs(self.lease_dir, exist_ok=True)
                path = self._lease_path(self.rank)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    f.write(json.dumps(payload))
                os.replace(tmp, path)
            self._publish_coord(payload)
        except OSError:
            self._renew_failing = True
            _count("fleet.lease_renew_failures_total")
            _fault.record("fleet.lease_renew_failure")
            return False
        self._renew_failing = False
        _count("fleet.heartbeats_total")
        if _insight._active and self.lease_dir:
            # the insight fleet snapshot rides the heartbeat cadence
            # (rate-limited by insight.snapshot_interval)
            _insight.maybe_snapshot(self.lease_dir, self.rank)
        if _blackbox._active and self.lease_dir:
            # shadow postmortem on the same cadence (rate-limited by
            # blackbox.checkpoint_interval): SIGKILL/OOM run no hook, so
            # the fleet always holds a recent bundle for this host
            _blackbox.maybe_checkpoint(self.lease_dir, self.rank,
                                       step=self._step)
        if _goodput._active and self.lease_dir:
            # goodput ledger snapshot on the same cadence (rate-limited by
            # goodput.snapshot_interval)
            _goodput.maybe_snapshot(self.lease_dir, self.rank)
        return True

    def _publish_coord(self, payload):
        """Best-effort mirror into the default ``torch.distributed``
        store (present only while a process group is up); the file store
        stays authoritative."""
        try:
            import torch.distributed as dist
            if not (dist.is_available() and dist.is_initialized()):
                return
            from torch.distributed import distributed_c10d
            store = distributed_c10d._get_default_store()
            store.set(f"mx.fleet/lease/{self.rank}/{payload['step']}",
                      json.dumps(payload))
        except Exception:   # noqa: BLE001 - strictly best-effort
            pass

    def note_step(self, step):
        """Record local training-loop progress (feeds the local watchdog
        and the step number published in the lease)."""
        step = int(step)
        if step != self._step:
            self._step = step
            self._step_mono = time.monotonic()

    # -- peer observation -----------------------------------------------

    def peers(self):
        """{rank: {"age": seconds since renewal, "step": last step}} for
        every peer lease currently on disk (own rank excluded)."""
        out = {}
        if not self.lease_dir or not os.path.isdir(self.lease_dir):
            return out
        now = time.time()
        for rank in range(self.nprocs):
            if rank == self.rank:
                continue
            try:
                with open(self._lease_path(rank)) as f:
                    lease = json.loads(f.read())
            except (OSError, ValueError):
                continue
            out[rank] = {"age": max(0.0, now - lease.get("time", 0.0)),
                         "step": int(lease.get("step", 0))}
            self._seen.add(rank)
        return out

    def check_peers(self):
        """Classify every previously-seen peer; raises
        :class:`~mxnet_tpu_torch.resilience.WorkerLost` for the first LOST
        or WEDGED one, updates the ``fleet.stragglers`` gauge for SLOW
        ones. Returns the ranks currently alive."""
        leases = self.peers()
        deadline = _config.get("fleet.step_deadline")
        slow_at = deadline * _config.get("fleet.slow_fraction")
        now = time.monotonic()
        alive = []
        self._stragglers.clear()
        for rank in sorted(self._seen):
            lease = leases.get(rank)
            if lease is None or lease["age"] > self.timeout:
                age = lease["age"] if lease else float("inf")
                _count("fleet.lease_expiries_total")
                _fault.record("fleet.lease_expiry")
                raise _resilience.WorkerLost(
                    op="lease", key=f"host-{rank}", rank=self.rank,
                    nprocs=self.nprocs, attempts=1,
                    last=f"lease age {age:.1f}s > fleet.lease_timeout "
                         f"{self.timeout:.1f}s")
            alive.append(rank)
            if deadline > 0:
                prev = self._peer_progress.get(rank)
                if prev is None or prev[0] != lease["step"]:
                    self._peer_progress[rank] = (lease["step"], now)
                    continue
                stuck = now - prev[1]
                if stuck > deadline:
                    raise _resilience.WorkerLost(
                        op="step_deadline", key=f"host-{rank}",
                        rank=self.rank, nprocs=self.nprocs, attempts=1,
                        last=f"peer step {lease['step']} stuck "
                             f"{stuck:.1f}s > fleet.step_deadline "
                             f"{deadline:.1f}s (wedged)")
                if stuck > slow_at > 0:
                    self._stragglers.add(rank)
        if _insight._active and self.lease_dir:
            # insight relative slowness: a host whose step-time EWMA (from
            # its fleet snapshot) sits past insight.straggler_ratio x the
            # fleet median is a straggler even without a step deadline
            ratio = _config.get("insight.straggler_ratio")
            for rank, rel in _insight.relative_slowness(
                    self.lease_dir).items():
                if rank != self.rank and rel > ratio:
                    self._stragglers.add(rank)
        _gauge("fleet.stragglers", len(self._stragglers))
        _gauge("fleet.peers_alive", len(alive) + 1)   # peers + self
        return alive

    # -- liveness (/healthz) --------------------------------------------

    def healthz(self):
        """The ``fleet`` /healthz provider (registered by :meth:`start`):
        red when own renewals fail, the local step loop is past
        ``fleet.step_deadline``, or a peer lease is stale."""
        detail = {"rank": self.rank, "step": self._step,
                  "renewing": not self._renew_failing}
        ok = not self._renew_failing
        deadline = _config.get("fleet.step_deadline")
        if deadline > 0:
            age = time.monotonic() - self._step_mono
            detail["step_age_s"] = round(age, 3)
            if age > deadline:
                ok, detail["local"] = False, "wedged"
        stale = [r for r, p in self.peers().items()
                 if p["age"] > self.timeout]
        if stale:
            ok, detail["stale_peers"] = False, stale
        detail["ok"] = ok
        return detail

    def start(self):
        """Register the /healthz provider and start the daemon renewal
        thread (one :meth:`beat` per ``fleet.lease_interval``). Idempotent
        while the thread runs; every start gets a FRESH stop event, so a
        loop that outlived its join timeout is never revived by a later
        start (two renewal loops would beat the same lease)."""
        _telemetry.register_health("fleet", self.healthz)
        with self._thread_lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            stop_evt = self._stop = threading.Event()

            def _loop():
                # close over THIS start's event: once stop() swaps in a
                # new one, this loop only sees its own, already-set event
                while not stop_evt.is_set():
                    self.beat()
                    stop_evt.wait(self.interval)

            self._thread = threading.Thread(
                target=_loop, name="mx-fleet-heartbeat", daemon=True)
            self._thread.start()
        return self

    def stop(self):
        """Clean exit: stop renewing, join the renewal thread, withdraw
        the lease file (so peers see a departure, not a loss), unregister
        from /healthz. Idempotent; a thread that fails to join inside the
        timeout stays referenced, so restart loops leak no renewal
        threads."""
        with self._thread_lock:
            self._stop.set()
            thread = self._thread
        if thread is not None:
            # join OUTSIDE the lock: a start() racing this stop must never
            # deadlock behind a slow join
            thread.join(timeout=5.0)
            if not thread.is_alive():
                with self._thread_lock:
                    if self._thread is thread:
                        self._thread = None
        _telemetry.unregister_health("fleet")
        if self.lease_dir:
            try:
                os.remove(self._lease_path(self.rank))
            except OSError:
                pass


# ---------------------------------------------------------------------------
# elastic supervisor
# ---------------------------------------------------------------------------

class FleetSupervisor:
    """Elastic degrade/re-expand driver around ONE
    :class:`~mxnet_tpu_torch.parallel.ShardedTrainStep` and its
    :class:`~mxnet_tpu_torch.resilience.TrainState` bundle, one on every
    rank of the world.

    The ranks are modeled as ``n_hosts`` equal shares of the target
    layout's ``size()`` (``host_index`` defaults to this rank's share). A
    host is lost either through the health plane (a peer's lease expired
    -> :class:`WorkerLost`, agreed over the world) or through the
    deterministic ``fleet.host_loss`` injection point (probed once per
    step). On loss::

        plan_layout(target, surviving_devices)   # prefer tp/pp, shrink dp
        step.rebuild(plan, sync=False)           # new mesh, same math
        state.load_latest_valid()                # bitwise, torn-safe
        ... training continues ...

    Below the ``fleet.min_dp`` floor the supervisor PARKS (gauge
    ``fleet.parked``) instead of thrashing; :meth:`restore_hosts` unparks
    it. Re-expansion back to the target layout happens at the next
    checkpoint boundary after every lost host rejoined. Each transition
    emits ``fleet``-category trace spans and ``fleet.*`` counters.
    """

    def __init__(self, step, state, n_hosts=1, host_index=None,
                 min_dp=None, checkpoint_every=1, health=None, stream=None):
        if step.mesh_config is None:
            raise MXNetError(
                "FleetSupervisor needs a ShardedTrainStep built from a "
                "MeshConfig (elastic re-planning re-factorizes its axes)")
        self.step = step
        self.state = state
        state.sharded_step = step
        self.target = step.mesh_config
        self.current = step.mesh_config
        self.n_hosts = int(n_hosts)
        if self.n_hosts < 1 or self.target.size() % self.n_hosts:
            raise MXNetError(
                f"n_hosts={n_hosts} must divide the target layout's "
                f"{self.target.size()} devices")
        self._dev_per_host = self.target.size() // self.n_hosts
        self._world, rank = _world()
        if self._world > 1 and self._world != self.target.size():
            raise MXNetError(
                f"FleetSupervisor over a world of {self._world} ranks needs "
                f"a target layout of as many; {self.target} has "
                f"{self.target.size()}")
        self.host_index = (int(host_index) if host_index is not None
                           else rank // self._dev_per_host)
        self.min_dp = (int(min_dp) if min_dp is not None
                       else _config.get("fleet.min_dp"))
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.health = health
        #: streaming data plane (a mx.stream.StreamSampler or a DataLoader
        #: wrapping one): lose_host also reassigns the dead host's
        #: unfinished shards to the survivors
        self.stream = stream
        self._lost: set[int] = set()
        #: host -> path of the dead host's latest valid postmortem bundle
        #: (attached to the fleet.degrade decision)
        self.postmortems: dict[int, str] = {}
        self._last_lost: int | None = None
        self.parked = False
        self._park_token = None
        self.degrades = 0
        self.reexpands = 0
        if _goodput._active:
            _goodput.set_devices(self._dev_per_host)
            _goodput.set_capacity(self.current.size(), self.target.size())
        _gauge("fleet.peers_expected", self.n_hosts)
        _gauge("fleet.peers_alive", self.n_hosts)
        _gauge("fleet.dp_size", self.current.dp)
        _gauge("fleet.parked", 0)

    # -- fleet membership ------------------------------------------------

    def alive_hosts(self):
        return [h for h in range(self.n_hosts) if h not in self._lost]

    @property
    def stranded(self):
        """Whether this rank lies outside the layout now training (its
        host was lost): it steps and saves nothing until a re-expand."""
        return bool(getattr(self.step, "stranded", False))

    def lose_host(self, host):
        """Mark ``host`` lost and re-plan immediately (the path both the
        health plane and the ``fleet.host_loss`` injection drive). In a
        world every rank calls it with the same host."""
        host = int(host)
        if host in self._lost:
            return
        if self._world > 1:
            if host == 0:
                raise MXNetError(
                    "fleet: host 0 lost; its ranks hold rank 0, where "
                    "make_mesh lays every layout, and a world without them "
                    "needs a re-formed process group, which this port does "
                    "not build")
        elif host == self.host_index:
            return
        self._lost.add(host)
        self._last_lost = host
        _fault.record("fleet.host_lost")
        _gauge("fleet.peers_alive", self.n_hosts - len(self._lost))
        # the dead host can't speak for itself: pick up its latest valid
        # postmortem bundle (terminal or <=interval-stale shadow) from the
        # shared bundle dir and carry it into the degrade decision
        bdir = _config.get("blackbox.dir") \
            or (self.health.lease_dir if self.health is not None else "") \
            or _config.get("fleet.lease_dir")
        if bdir:
            bundle = _blackbox.latest_bundle(bdir, rank=host)
            if bundle:
                self.postmortems[host] = bundle
        self._replan()
        # the data plane follows the compute plane: the dead host's
        # unfinished shards move to the survivors exactly once, resumed
        # from its last checkpointed cursor (what it served past that
        # checkpoint rolled back with the bundle)
        if self.stream is not None:
            sdir = ((self.health.lease_dir if self.health is not None
                     else "") or _config.get("fleet.lease_dir"))
            try:
                self.stream.take_over_host(
                    host, survivors=self.alive_hosts(),
                    cursor_dir=sdir or None)
            except OSError:
                pass    # shared dir unreadable: the shards stay lost until
                        # a retried lose_host or a manual reassign

    def restore_hosts(self, *hosts):
        """Mark lost hosts as rejoined (all of them by default). The mesh
        does NOT re-expand here: that happens at the next checkpoint
        boundary, where a fresh bundle is guaranteed."""
        if hosts:
            self._lost.difference_update(int(h) for h in hosts)
        else:
            self._lost.clear()
        _gauge("fleet.peers_alive", self.n_hosts - len(self._lost))
        if self.parked:
            self.parked = False
            _gauge("fleet.parked", 0)
            if self._park_token is not None:
                _goodput.end(self._park_token)
                self._park_token = None

    # -- plan / apply ----------------------------------------------------

    def _replan(self):
        avail = self._dev_per_host * (self.n_hosts - len(self._lost))
        plan = (plan_layout(self.target, avail, min_dp=self.min_dp)
                if avail else None)
        if plan is None:
            self.parked = True
            _gauge("fleet.parked", 1)
            if _goodput._active and self._park_token is None:
                # open-ended: every parked second is badput until
                # restore_hosts() closes the bracket
                self._park_token = _goodput.begin("parked")
            _fault.record("fleet.park")
            with _trace.span("fleet.park", category="fleet",
                             devices=avail, min_dp=self.min_dp):
                pass
            return None
        if self._world > 1 and self._lost and \
                plan.size() > self._dev_per_host * min(self._lost):
            raise MXNetError(
                f"fleet: {plan} needs ranks 0-{plan.size() - 1}, and "
                f"host {min(self._lost)} (ranks "
                f"{min(self._lost) * self._dev_per_host}-"
                f"{(min(self._lost) + 1) * self._dev_per_host - 1}) is "
                "lost: make_mesh lays a layout on the lowest ranks, so only "
                "the loss of the highest live hosts degrades in place")
        if plan != self.current:
            self._apply(plan, kind="degrade")
        return plan

    def _restore(self):
        """Every rank restores from the newest valid bundle: the layout's
        ranks load it into the step; a stranded rank takes only its step
        counter (and RNG), loading no state."""
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.barrier()   # rank 0's newest bundle is on disk
        if not self.state.exists():
            return
        if self.stranded:
            self.state.sharded_step = None
            try:
                self.state.load_latest_valid()
            finally:
                self.state.sharded_step = self.step
        else:
            self.state.load_latest_valid()

    def _apply(self, cfg, kind):
        """Rebuild the step around ``cfg`` and restore the newest valid
        bundle bitwise into it (step counter, RNG, optimizer state ride
        along: the run resumes exactly at the last checkpoint)."""
        # the whole transition (rebuild + bundle restore) is restart
        # badput; restart outranks the nested restore claim, so the ledger
        # counts the downtime exactly once
        tok = _goodput.begin("restart") if _goodput._active else None
        with _trace.span(f"fleet.{kind}", category="fleet", dp=cfg.dp,
                         tp=cfg.tp, pp=cfg.pp, devices=cfg.size()) as sp:
            if kind == "degrade" and self._last_lost is not None:
                pm = self.postmortems.get(self._last_lost)
                if pm:
                    sp.set(postmortem=pm, postmortem_host=self._last_lost)
            with _trace.span("fleet.rebuild", category="fleet"):
                # sync=False: the dying layout's buffers may be gone; all
                # state transfers through the canonical bundle
                new_step = self.step.rebuild(cfg, sync=False)
            self.step = new_step
            self.state.sharded_step = new_step
            self._restore()
        if tok is not None:
            _goodput.end(tok)
        if _goodput._active:
            _goodput.set_capacity(cfg.size(), self.target.size())
        self.current = cfg
        _gauge("fleet.dp_size", cfg.dp)
        if kind == "degrade":
            self.degrades += 1
            _count("fleet.degrades_total")
            _fault.record("fleet.degrade")
        else:
            self.reexpands += 1
            _count("fleet.reexpands_total")
            _fault.record("fleet.reexpand")

    def _maybe_reexpand(self):
        if (self._lost or self.parked or self.current == self.target
                or self.state.step % self.checkpoint_every):
            return
        self._apply(self.target, kind="reexpand")

    # -- the per-step probe and the drill driver -------------------------

    def _agree(self, hosts):
        """The hosts any rank saw lost this probe (a max all-reduce over
        the world of one flag a host); ``hosts`` itself without a
        world."""
        if self._world <= 1:
            return sorted(set(hosts))
        import torch
        from . import _dist_init
        from .parallel import collectives as _coll
        flags = torch.zeros(self.n_hosts, dtype=torch.int32,
                            device=_dist_init.rank_device() or "cpu")
        for h in hosts:
            flags[int(h)] = 1
        flags = _coll.allreduce(flags, None, "dp", "max")
        return [h for h, f in enumerate(flags.tolist()) if f]

    def probe(self, step_no=None):
        """Run once per training step on every rank: advance the
        heartbeat, scrape the health plane, and evaluate the deterministic
        fault points. Returns False while parked."""
        if self.health is not None:
            self.health.beat(step=step_no)
            seen = []
            try:
                self.health.check_peers()
            except _resilience.WorkerLost as e:
                # the lease names the dead peer's host share
                seen.append(int(str(e.key).rsplit("-", 1)[-1])
                            if "-" in str(e.key) else 0)
            for host in self._agree(seen):
                self.lose_host(host)
        if _fault._active and _fault.fire("fleet.slow_host", step=step_no):
            _fault.record("fleet.straggler")
            _gauge("fleet.stragglers", 1)
        if _fault._active and _fault.fire("fleet.host_loss", step=step_no):
            # the reference controller's (host 0's) victim, on every rank
            survivors = [h for h in self.alive_hosts() if h != 0]
            if survivors:   # nobody left to lose -> ignore the probe
                self.lose_host(max(survivors))
        self._maybe_reexpand()
        return not self.parked

    def run(self, batch_fn, total_steps):
        """Drive training to ``total_steps``: probe, pull the batch FOR THE
        STEP BEING (RE)COMPUTED via ``batch_fn(step_number)``, step,
        checkpoint every ``checkpoint_every`` steps. A degrade rolls the
        step counter back to the last checkpoint, and ``batch_fn`` keyed
        by step number replays exactly the batches the oracle run sees.
        Returns {step: loss} for every step this rank computed last (the
        authoritative value per step: recomputed steps overwrite). A
        stranded rank computes nothing and only keeps the count. Parking
        breaks the loop; call :meth:`restore_hosts` then ``run`` again to
        continue."""
        losses = {}
        while self.state.step < total_steps:
            self.probe(self.state.step + 1)
            if self.parked:
                break
            s = self.state.step + 1   # a degrade may have rolled us back
            if self.stranded:
                self.state.step = s
                continue
            loss = self.step(*batch_fn(s))
            losses[s] = loss
            self.state.step = s
            if s % self.checkpoint_every == 0 and self.state.path:
                self.state.save()
                if self.stream is not None:
                    # the cursor travels inside the bundle when the stream
                    # is the TrainState loader; the shared-dir copy (what
                    # survivors roll forward) refreshes at the same
                    # boundary either way
                    try:
                        self.stream.publish_cursor()
                    except OSError:
                        pass
        return losses
