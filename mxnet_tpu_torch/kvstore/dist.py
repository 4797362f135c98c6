"""Distributed KVStore ("dist_sync", "dist_device_sync", "dist_async").

Counterpart of ``mxnet_tpu/kvstore/dist.py`` (reference: src/kvstore/
kvstore_dist.h + kvstore_dist_server.h, ps-lite worker/server/scheduler).
There is no parameter server: a push's cross-process reduce is an
all-reduce over the ``torch.distributed`` group that import joined
(``_dist_init``; ``tools/launch.py`` sets its environment), and
``update_on_kvstore`` runs the updater on every rank after the reduce —
the same state on every rank, bit for bit, without a server round trip.
With no launcher the world is one process and the store is the local one.

Gradient compression (the 1-bit / 2-bit codes of
``gradient_compression.py``) quantizes each rank's local sum with its
residual before the reduce; the sum of the quantized values is exact.

Every collective runs under a watchdog (``kvstore.async_timeout``: the
collective issued without waiting, the caller waiting for it with a
deadline, a miss raising :class:`CollectiveTimeout`), with a bounded
retry: backoff from ``kvstore.retry_backoff`` doubling with up to 25%
jitter, a rejoin at a barrier in the process group's store (the reference
uses the coordination service), then the same attempt waited for again
(one that never reached the group issued again), ``kvstore.retry_max``
times; then a ``resilience.WorkerLost``, and the group given up when the
attempt is still in it (see :meth:`DistKVStore._collective`). Each completed collective feeds
``kvstore.collective_seconds`` / ``kvstore.collective_total`` /
``kvstore.payload_bytes_total``; a failed one
``kvstore.collective_errors_total``.

"dist_async" (:class:`DistAsyncKVStore`) keeps one store replica per
process: a push updates the local replica with the local gradient (no
collective); a pull reconciles, every replica becoming the mean of the
replicas. As in the reference, every process must pull the same keys in
the same order the same number of times.
"""
from __future__ import annotations

import itertools
import random as _pyrandom
import time

import torch

from .. import config as _config
from .. import fault as _fault
from .. import telemetry as _telemetry
from .._dist_init import ensure_distributed as _ensure_distributed
from ..base import MXNetError
from .base import _assign, _raw
from .kvstore import KVStore

__all__ = ["CollectiveTimeout", "DistKVStore", "DistAsyncKVStore"]

#: the store collectives' sequence number: every rank runs them in the
#: same order, so it names one collective on every rank (rejoin keys)
_SEQ = itertools.count()


def _abandon(reason):
    from .._dist_init import abandon
    abandon(reason)


class CollectiveTimeout(MXNetError):
    """A blocking cross-process collective missed its deadline: ``op``,
    ``key``, ``rank`` / ``nprocs`` and ``elapsed`` (seconds waited)."""

    def __init__(self, op, key, rank, nprocs, elapsed, hint=""):
        self.op = op
        self.key = key
        self.rank = rank
        self.nprocs = nprocs
        self.elapsed = elapsed
        msg = (f"collective '{op}' for key {key!r} timed out after "
               f"{elapsed:.1f}s on rank {rank}/{nprocs}."
               f"{(' ' + hint) if hint else ''} Raise mx.config "
               "'kvstore.async_timeout' if the collective is merely slow.")
        super().__init__(msg)


class DistKVStore(KVStore):
    """Multi-process KVStore over ``torch.distributed`` collectives."""

    def __init__(self, name="dist_sync"):
        super().__init__(name)
        _ensure_distributed()
        import torch.distributed as dist
        on = dist.is_available() and dist.is_initialized()
        self._nprocs = dist.get_world_size() if on else 1
        self._rank = dist.get_rank() if on else 0

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._nprocs

    def set_gradient_compression(self, compression_params):
        """1-bit / 2-bit compression of each rank's sum before the
        reduce (reference: kvstore.h ``SetGradientCompression``)."""
        from .gradient_compression import GradientCompression
        self._gc = GradientCompression(**dict(compression_params or {}))

    def _watchdog_engaged(self):
        # many processes always; one only with the fault point armed (so
        # tests exercise the machinery alone, and a world of one pays
        # nothing)
        return self._nprocs > 1 or _fault.armed("kvstore.collective_timeout")

    def _start(self, value):
        """Issue the cross-process sum of ``value`` without waiting:
        ``(work, out)``, ``out`` holding the sum once ``work`` has
        completed (``work`` None on a world of one)."""
        from ..parallel.collectives import start_allreduce
        return start_allreduce(value)

    def _issue(self, value):
        """An attempt at the sum of ``value``: :meth:`_start`'s pair, or
        None where the ``kvstore.collective_timeout`` fault point fires
        (an attempt that never reaches the group)."""
        if _fault._active and _fault.fire("kvstore.collective_timeout"):
            return None
        return self._start(value)

    def _timed_wait(self, op, key, att, hint=""):
        """The result of attempt ``att`` (see :meth:`_issue`) within
        ``kvstore.async_timeout``; a miss raises :class:`CollectiveTimeout`
        with the attempt still in the group (this thread waited with a
        deadline, so nothing stays blocked in it); a failed attempt
        raises its error."""
        from ..parallel.collectives import wait_work
        timeout = _config.get("kvstore.async_timeout")
        start = time.monotonic()
        if att is None:
            time.sleep(timeout)
        elif wait_work(att[0], timeout):
            out = att[1]
            if out.is_cuda:
                torch.cuda.current_stream(out.device).synchronize()
            return out
        _fault.record("kvstore.collective_timeout_raised")
        raise CollectiveTimeout(op, key, self.rank, self.num_workers,
                                time.monotonic() - start, hint)

    @staticmethod
    def _is_transient(e):
        """The watchdog's timeout, and transport errors whose message
        marks them as transient (a preempted peer shows as one)."""
        if isinstance(e, CollectiveTimeout):
            return True
        msg = str(e).lower()
        return any(tok in msg for tok in (
            "deadline exceeded", "unavailable", "connection reset",
            "connection refused", "broken pipe", "barrier timed out"))

    def _rejoin(self, op, seq, attempt, pending):
        """Barrier of the ranks retrying collective ``seq`` in the process
        group's store, for ``kvstore.rejoin_timeout``; it also ends when
        ``pending`` (the work of this rank's attempt, still in the group)
        completes.
        A miss is counted (``resilience.rejoin_failed``): it decides
        nothing, since no rank issues an attempt twice."""
        if self._nprocs <= 1:
            return True
        try:
            import torch.distributed as dist
            store = dist.distributed_c10d._get_default_store()
            key = f"mxtpu_rejoin_{seq}_a{attempt}"
            store.add(key, 1)
            timeout = float(_config.get("kvstore.rejoin_timeout"))
            deadline = time.monotonic() + timeout
            while int(store.add(key, 0)) < self._nprocs:
                if pending is not None and pending.is_completed():
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"barrier timed out ({key}, {timeout:.1f}s)")
                time.sleep(0.01)
        except Exception:  # noqa: BLE001 - counted, decides nothing
            _fault.record("resilience.rejoin_failed")
            if _telemetry._active:
                _telemetry.inc("resilience.rejoin_failed_total", op=op)
            return False
        _fault.record("resilience.rejoin")
        if _telemetry._active:
            _telemetry.inc("resilience.rejoin_total", op=op)
        return True

    def _collective(self, op, key, value, hint=""):
        """The cross-process sum of ``value``, watchdogged, with bounded
        retry-with-rejoin; an exhausted budget escalates
        ``resilience.WorkerLost``. ``kvstore.retry_max=0`` raises on the
        first timeout.

        A retry never issues the collective twice: an attempt that reached
        the process group (a slow peer, a stalled transport) is waited for
        again, since issuing it anew would pair with a peer's next
        collective; only an attempt that never reached the group (the
        ``kvstore.collective_timeout`` fault point) is issued again. So
        every rank issues each collective once, and a peer that is merely
        slow completes it. Giving up on an attempt that is still in the
        group, or that failed in it, gives the process group up
        (``_dist_init.abandon``): later collectives raise instead of
        pairing with it."""
        retry_max = int(_config.get("kvstore.retry_max"))
        backoff = float(_config.get("kvstore.retry_backoff"))
        seq = next(_SEQ)
        att, tries = None, 0
        while True:
            try:
                if att is None:
                    att = self._issue(value)
                return self._timed_wait(op, key, att, hint)
            except Exception as e:  # noqa: BLE001 - filtered just below
                transient = self._is_transient(e)
                work = None if att is None else att[0]
                done = work is None or work.is_completed()
                # pending: still in the group; spent: ended with an error
                # in the group, the peers' side of it unknown
                pending, spent = att is not None and not done, \
                    att is not None and done
                tries += 1
                if not (retry_max > 0 and transient and not spent
                        and tries <= retry_max):
                    if pending or (spent and transient):
                        _abandon(f"collective '{op}' for key {key!r} was "
                                 f"given up on rank {self.rank} after "
                                 f"{tries} tries: {e}")
                    if retry_max <= 0 or not transient:
                        raise
                    from ..resilience import WorkerLost, _event
                    _event("worker_lost_raised", op=op.partition("#")[0])
                    raise WorkerLost(op, key, self.rank, self.num_workers,
                                     tries, e) from e
                _fault.record("resilience.collective_retry")
                if _telemetry._active:
                    _telemetry.inc("resilience.collective_retry_total",
                                   op=op)
                delay = backoff * (2 ** (tries - 1))
                if delay > 0:
                    time.sleep(delay * (1.0 + 0.25 * _pyrandom.random()))
                self._rejoin(op, seq, tries, work if pending else None)

    def _count_collective(self, op, t0, payload):
        """Success-path telemetry for one completed collective."""
        if not _telemetry._active:
            return
        _telemetry.observe("kvstore.collective_seconds",
                           time.perf_counter() - t0, op=op)
        _telemetry.inc("kvstore.collective_total", op=op)
        raw = _raw(payload)
        _telemetry.inc("kvstore.payload_bytes_total",
                       int(raw.numel() * raw.element_size()))

    def _allreduce(self, merged):
        """Cross-process sum (no deadline here); identity on one process."""
        if self._nprocs == 1:
            return merged
        from ..parallel.collectives import allreduce_across_processes
        return allreduce_across_processes(merged)

    def _merged(self, k, vs):
        """Local sum, optional quantization, cross-process sum (under the
        watchdog when engaged). Telemetry counts the payload shipped (after
        quantization)."""
        merged = KVStore._merged(self, k, vs)
        t0 = time.perf_counter()
        try:
            if not self._watchdog_engaged():
                out = self._allreduce(merged)
            else:
                out = self._collective("allreduce", k, merged)
        except Exception:
            if _telemetry._active:
                _telemetry.inc("kvstore.collective_errors_total",
                               op="allreduce")
            raise
        self._count_collective("allreduce", t0, merged)
        return out


class DistAsyncKVStore(DistKVStore):
    """"dist_async": per-process immediate updates, reconciling pulls.

    ``push`` runs the updater on the LOCAL replica with only the local
    gradient (no collective); ``pull`` / ``pushpull(out=...)`` average the
    replicas over the processes and the local replica adopts the mean.
    Until a worker pulls it does not see the others' updates."""

    def __init__(self, name="dist_async"):
        super().__init__(name)

    @torch.no_grad()
    def push(self, key, value, priority=0):
        keys, values = self._normalize(key, value)
        for k, vs in zip(keys, values):
            self._check(k)
            merged = KVStore._merged(self, k, vs)  # local only
            if self._updater is not None:
                self._updater(self._key_int(k), merged, self._store[k])
            else:
                self._store[k].copy_(merged)

    def _reconcile(self, k):
        """Average the replicas across processes under the watchdog; a
        timeout names the key and this process's reconcile count, since a
        mismatched pull schedule hangs the collective."""
        if self._watchdog_engaged():
            self._reconcile_seq = getattr(self, "_reconcile_seq", 0) + 1
            t0 = time.perf_counter()
            try:
                summed = self._collective(
                    f"reconcile#{self._reconcile_seq}", k, self._store[k],
                    hint="Every process must pull the same keys in the "
                         "same order the same number of times (SPMD "
                         "collective constraint); a data-dependent pull "
                         "schedule deadlocks here — align the pull "
                         "schedule.")
            except Exception:
                if _telemetry._active:
                    _telemetry.inc("kvstore.collective_errors_total",
                                   op="reconcile")
                raise
            self._count_collective("reconcile", t0, summed)
            with torch.no_grad():
                self._store[k].copy_(summed / self._nprocs)
        return self._store[k]

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = self._normalize(key, out)
        for k, o in zip(keys, outs):
            self._check(k)
            src = self._reconcile(k)
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                _assign(t, src)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out=out, priority=priority)
