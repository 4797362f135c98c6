"""mx.resilience — elastic training: preemption-safe TrainState bundles,
deterministic mid-epoch resume, and supervised restarts.

Counterpart of ``mxnet_tpu/resilience.py``:

- :class:`TrainState` bundles {parameters, the trainer's optimizer and
  updater states (``multi_precision`` masters and the fused update's
  states are the updater's states), the loss scaler, the sampler / loader
  cursor, the RNG streams (``random.get_state``: every torch default
  generator and numpy's), step and epoch} into ONE crash-atomic
  checksummed file (``serialization.atomic_write_bytes`` + a ``.sha256``
  sidecar), so a resume continues at the exact next batch with
  bit-identical losses. Parameters are stored bit for bit in their own
  dtype (bf16 as its 16-bit pattern).
- Signal handling turns SIGTERM/SIGINT into a cooperative preemption: the
  in-flight step finishes, the bundle is written, and training stops with
  :class:`Preempted` (exit sentinel :data:`RESUME_EXIT_CODE`). The
  ``resilience.preempt`` injection point drives the same path.
- :func:`run` supervises a training function: a :class:`WorkerLost`
  (``stream.ShardUnreadable`` is one) restores the last bundle and
  re-enters the function within ``resilience.max_restarts``.

Every recovery event lands in ``mx.fault.stats()`` and, while telemetry
is on, as ``resilience.*`` counters. The dist kvstore's bounded
collective retries escalate a ``WorkerLost`` (``kvstore/dist.py``), and
``TrainState(sharded_step=...)`` bundles a ``parallel.ShardedTrainStep``'s
canonical state (every rank calls ``save``; the gather is collective).
"""
from __future__ import annotations

import os
import pickle
import signal as _signal
import threading
import time

import numpy as onp
import torch

from . import config as _config
from . import fault as _fault
from . import goodput as _goodput
from . import random as _random
from . import serialization as _serialization
from . import telemetry as _telemetry
from .base import MXNetError

__all__ = ["TrainState", "Preempted", "WorkerLost", "RESUME_EXIT_CODE",
           "install_signal_handlers", "uninstall_signal_handlers",
           "preempt_requested", "clear_preempt", "run"]

#: process exit status of a run that stopped on preemption with a bundle on
#: disk — BSD EX_TEMPFAIL, the "transient, retry me" sentinel schedulers
#: and supervisors (systemd, batch wrappers) already understand
RESUME_EXIT_CODE = 75

#: TrainState bundle wire-format version (bundles from a newer format
#: refuse to load instead of silently dropping fields)
BUNDLE_VERSION = 1


def _event(name, **labels):
    """Count a recovery event in mx.fault stats AND as a resilience.*
    telemetry counter: every recovery is visible."""
    _fault.record("resilience." + name)
    if _telemetry._active:
        _telemetry.inc("resilience." + name + "_total", **labels)


class Preempted(MXNetError):
    """Training stopped cooperatively on a preemption signal (or the
    ``resilience.preempt`` injection); the TrainState bundle at ``path``
    holds everything a restarted process needs to continue."""

    def __init__(self, path=None, step=None, origin="signal"):
        self.path = path
        self.step = step
        self.origin = origin
        at = f" at step {step}" if step is not None else ""
        where = f"; resume bundle: {path}" if path else ""
        super().__init__(
            f"training preempted ({origin}){at}{where}. Restart the job "
            f"and restore the bundle (exit sentinel {RESUME_EXIT_CODE}).")


class WorkerLost(MXNetError):
    """A peer, the fabric to it, or a data shard is gone: a bounded retry
    budget was exhausted (``stream.ShardUnreadable``; in the reference also
    the dist kvstore's collectives).  Structured so supervisors can dispatch on the
    fields: ``op``/``key`` (the collective that died), ``rank``/``nprocs``,
    ``attempts`` (tries made), ``last`` (the final underlying error)."""

    def __init__(self, op, key, rank, nprocs, attempts, last):
        self.op = op
        self.key = key
        self.rank = rank
        self.nprocs = nprocs
        self.attempts = attempts
        self.last = last
        super().__init__(
            f"worker lost: collective '{op}' for key {key!r} failed "
            f"{attempts}x with rejoin on rank {rank}/{nprocs}; last error: "
            f"{last}")


def _pack_tensor(t):
    """A parameter as bundle data, bit for bit: (dtype name, numpy array),
    bf16 as its int16 bit pattern."""
    t = t.detach().cpu()
    if t.dtype is torch.bfloat16:
        return ("bfloat16", t.view(torch.int16).numpy().copy())
    return (str(t.dtype).replace("torch.", ""), t.numpy().copy())


def _unpack_tensor(packed):
    name, arr = packed
    t = torch.from_numpy(onp.ascontiguousarray(arr))
    return t.view(torch.bfloat16) if name == "bfloat16" else t


# ---------------------------------------------------------------------------
# preemption signals
# ---------------------------------------------------------------------------

_preempt_flag = threading.Event()
_prev_handlers: dict[int, object] = {}


def _on_signal(signum, frame):
    _preempt_flag.set()
    _event("preempt_signal", signal=_signal.Signals(signum).name)


def install_signal_handlers(signals=(_signal.SIGTERM, _signal.SIGINT)):
    """Install graceful-shutdown handlers: the signal only sets a flag;
    the training loop observes it via :func:`preempt_requested` after the
    in-flight step, writes the bundle, and stops.  Returns the list of
    signals actually hooked (empty off the main thread, where CPython
    forbids ``signal.signal``)."""
    hooked = []
    for sig in signals:
        try:
            _prev_handlers[sig] = _signal.signal(sig, _on_signal)
            hooked.append(sig)
        except ValueError:       # not the main thread
            break
    return hooked


def uninstall_signal_handlers():
    """Restore whatever handlers were displaced (idempotent)."""
    while _prev_handlers:
        sig, prev = _prev_handlers.popitem()
        try:
            _signal.signal(sig, prev)
        except (ValueError, TypeError):
            pass


def preempt_requested(step=None):
    """True when a preemption signal arrived OR the ``resilience.preempt``
    injection point fires on this probe (one probe per training step, so
    ``resilience.preempt:at=N`` preempts deterministically at step N)."""
    if _preempt_flag.is_set():
        return True
    if _fault._active and _fault.fire("resilience.preempt", step=step):
        _preempt_flag.set()
        return True
    return False


def clear_preempt():
    """Drop a pending preemption flag (after it has been honored)."""
    _preempt_flag.clear()


# ---------------------------------------------------------------------------
# TrainState bundles
# ---------------------------------------------------------------------------

class TrainState:
    """Crash-atomic checksummed bundle of everything a mid-epoch resume
    needs: parameters, optimizer/updater states, loss-scaler, sampler
    cursor, RNG streams, step/epoch counters.

    The object holds live references (``net``/``trainer``/``loader`` are
    optional — bundle whatever the run has) and moves state in place::

        state = mx.resilience.TrainState(net=net, trainer=trainer,
                                         loader=loader, path="run.bundle")
        ...
        state.step += 1            # after every optimizer step
        state.save()               # on preemption (ResilienceHandler does)
        ...
        state.load()               # in the restarted process

    ``save`` writes ONE file via the crash-atomic machinery
    (same-dir temp + fsync + ``os.replace``) plus a ``.sha256`` sidecar;
    ``load`` validates the checksum first, so a bundle torn by the very
    preemption it was written under is rejected loudly, never half-loaded.
    """

    def __init__(self, net=None, trainer=None, loader=None, path=None,
                 sharded_step=None):
        if sharded_step is not None and not (
                hasattr(sharded_step, "state_dict")
                and hasattr(sharded_step, "load_state_dict")):
            raise MXNetError(
                "TrainState(sharded_step=...) takes a step with "
                "state_dict() / load_state_dict() (parallel."
                f"ShardedTrainStep), got {type(sharded_step).__name__}")
        self.net = net
        self.trainer = trainer
        self.loader = loader
        self.sharded_step = sharded_step
        self.path = path
        self.step = 0
        self.epoch = 0

    # -- capture -----------------------------------------------------------
    def state_dict(self):
        bundle = {"version": BUNDLE_VERSION, "step": int(self.step),
                  "epoch": int(self.epoch), "rng": _random.get_state(),
                  "saved_unix": time.time()}
        if self.net is not None:
            bundle["params"] = {
                name: _pack_tensor(p.data())
                for name, p in self.net.collect_params().items()
                if p.initialized}
        if self.trainer is not None:
            bundle["trainer"] = self.trainer.state_dict()
        if self.loader is not None:
            bundle["loader"] = self.loader.state_dict()
        if self.sharded_step is not None:
            bundle["sharded_step"] = self.sharded_step.state_dict()
        return bundle

    def save(self, path=None):
        path = path or self.path
        if path is None:
            raise MXNetError("TrainState.save: no bundle path configured")
        tok = _goodput.begin("checkpoint_save") if _goodput._active else None
        try:
            self._save_bundle(path)
        finally:
            _goodput.end(tok)
        return path

    def _save_bundle(self, path):
        state = self.state_dict()
        if getattr(self.sharded_step, "rank", 0) != 0:
            # a data-parallel step's state is gathered by every rank (a
            # collective); rank 0 alone writes the bundle
            return
        blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
        _serialization.atomic_write_bytes(path, blob)
        _serialization.write_checksum(path)
        _event("bundle_save")
        self._gc(path)
        # streaming loaders additionally publish their cursor to the
        # shared fleet dir at every checkpoint: the bundle owns the
        # cursor for *this* host's restarts, the published copy is what
        # a SURVIVOR rolls forward when this host dies (mx.stream
        # take_over_host). Best-effort: shared storage hiccups must not
        # fail the checkpoint that just landed.
        publish = getattr(self.loader, "publish_cursor", None)
        if publish is not None:
            try:
                publish()
            except OSError:
                pass
        from . import blackbox as _blackbox
        if _blackbox._active:
            # the postmortem names the exact checkpoint generation a
            # replacement host will restore
            _blackbox.note_checkpoint(
                path, self.step,
                generation=f"{path}.g{int(self.step):08d}")
        return path

    # -- retention ---------------------------------------------------------
    @staticmethod
    def _history(path):
        """Existing ``<path>.gN`` generation bundles, oldest step first
        (the zero-padded step number in the name makes lexical order
        chronological)."""
        import glob as _glob
        suffix = _serialization.CHECKSUM_SUFFIX
        return sorted(p for p in _glob.glob(_glob.escape(path) + ".g*")
                      if not p.endswith(suffix))

    def _gc(self, path):
        """Retention GC, run after every successful ``save``: hard-link the
        fresh primary into a ``<path>.gN`` generation (N = step), then
        delete torn generations and everything older than the newest
        ``resilience.keep_bundles`` — the guaranteed-valid fallback chain
        :meth:`load_latest_valid` walks.  ``keep_bundles=0`` keeps the
        primary only (pre-GC behaviour)."""
        keep = _config.get("resilience.keep_bundles")
        if keep <= 0:
            return
        suffix = _serialization.CHECKSUM_SUFFIX
        gen = f"{path}.g{int(self.step):08d}"
        for src, dst in ((path, gen), (path + suffix, gen + suffix)):
            if os.path.exists(dst):
                os.remove(dst)
            try:
                os.link(src, dst)
            except OSError:                # filesystem without hard links
                import shutil
                shutil.copyfile(src, dst)
        survivors = []
        for p in self._history(path):
            try:
                _serialization.verify_checksum(p, required=True)
            except MXNetError:
                self._unlink_gen(p, suffix)
                _event("bundle_gc", reason="torn")
                continue
            survivors.append(p)
        for p in survivors[:-keep]:
            self._unlink_gen(p, suffix)
            _event("bundle_gc", reason="retention")

    @staticmethod
    def _unlink_gen(p, suffix):
        for stale in (p, p + suffix):
            try:
                os.remove(stale)
            except FileNotFoundError:
                pass

    # -- restore -----------------------------------------------------------
    def load(self, path=None):
        """Validate, read and apply the bundle at ``path`` (default: the
        configured path).  Raises :class:`MXNetError` on a missing file,
        checksum mismatch, or a newer bundle format."""
        path = path or self.path
        if path is None or not os.path.exists(path):
            raise MXNetError(f"TrainState.load: no bundle at {path!r}")
        tok = _goodput.begin("restore") if _goodput._active else None
        try:
            _serialization.verify_checksum(path)
            with open(path, "rb") as f:
                try:
                    bundle = pickle.loads(f.read())
                except Exception as e:  # noqa: BLE001 - torn/corrupt pickle
                    raise MXNetError(
                        f"{path}: corrupt TrainState bundle ({e})") from e
            self.restore(bundle)
        finally:
            _goodput.end(tok)
        return bundle

    def load_latest_valid(self, path=None):
        """Restore from the newest bundle that passes validation: the
        primary first, then the retention history (``<path>.gN``,
        newest first).  The fleet degrade path uses this — a host can die
        mid-``save`` and leave the primary torn, and the survivors must
        fall back to the previous generation instead of dying on it.
        Plain :meth:`load` keeps its strict raise-on-torn contract.
        Returns the path actually restored."""
        path = path or self.path
        if path is None:
            raise MXNetError(
                "TrainState.load_latest_valid: no bundle path configured")
        candidates = [path] + list(reversed(self._history(path)))
        last_err = None
        tok = _goodput.begin("restore") if _goodput._active else None
        try:
            for p in candidates:
                if not os.path.exists(p):
                    continue
                try:
                    _serialization.verify_checksum(p)
                    with open(p, "rb") as f:
                        bundle = pickle.loads(f.read())
                except Exception as e:  # noqa: BLE001 - torn: next gen
                    last_err = e
                    continue
                self.restore(bundle)
                return p
        finally:
            _goodput.end(tok)
        raise MXNetError(
            f"TrainState.load_latest_valid: no valid bundle at {path!r} "
            f"or its history; last error: {last_err}")

    def restore(self, bundle):
        """Apply an already-deserialized bundle to the live objects."""
        version = bundle.get("version", 0)
        if version > BUNDLE_VERSION:
            raise MXNetError(
                f"TrainState bundle format v{version} is newer than this "
                f"build's v{BUNDLE_VERSION}; upgrade before resuming")
        params = bundle.get("params")
        if params is not None and self.net is not None:
            mine = self.net.collect_params()
            for name, p in mine.items():
                if name in params:
                    p.set_data(_unpack_tensor(params[name]))
                elif p.initialized:
                    raise MXNetError(
                        f"TrainState bundle is missing parameter {name!r}; "
                        "refusing a silent partial restore")
        if bundle.get("trainer") is not None and self.trainer is not None:
            self.trainer.load_state_dict(bundle["trainer"])
        if bundle.get("loader") is not None and self.loader is not None:
            self.loader.load_state_dict(bundle["loader"])
        if (bundle.get("sharded_step") is not None
                and self.sharded_step is not None):
            self.sharded_step.load_state_dict(bundle["sharded_step"])
        if bundle.get("rng") is not None:
            _random.set_state(bundle["rng"])
        self.step = int(bundle.get("step", 0))
        self.epoch = int(bundle.get("epoch", 0))
        _event("bundle_restore")

    def exists(self, path=None):
        path = path or self.path
        return path is not None and os.path.exists(path)


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------

def run(train_fn, state=None, max_restarts=None, exit_on_preempt=False,
        resume_on_preempt=False):
    """Supervise ``train_fn`` (a zero-arg callable) against worker loss
    and preemption.

    - :class:`WorkerLost` (a bounded retry budget exhausted, such as a
      shard that stayed unreadable): restore the last TrainState bundle (when ``state`` is
      given and a bundle exists) and re-enter ``train_fn``, up to
      ``max_restarts`` times (default: the ``resilience.max_restarts``
      knob); then re-raise.
    - :class:`Preempted`: the bundle was already written by the preempt
      path.  With ``exit_on_preempt=True`` the process exits with
      :data:`RESUME_EXIT_CODE` so the scheduler reschedules it; with
      ``resume_on_preempt=True`` (and a restorable ``state``) the
      supervisor instead restores the bundle in-process and re-enters
      ``train_fn`` against the restart budget — single-host runs where
      the "scheduler" is this very process; otherwise the exception
      propagates to the caller (tests, notebooks).

    Returns whatever ``train_fn`` returns on success.
    """
    budget = (max_restarts if max_restarts is not None
              else _config.get("resilience.max_restarts"))
    window = _config.get("resilience.restart_window_steps")
    restarts = 0
    prev_step = None
    while True:
        try:
            return train_fn()
        except Preempted as e:
            # SystemExit never reaches sys.excepthook, so the exit-75
            # path must freeze its evidence here, before the bundle of
            # record is the only artifact the host leaves behind
            from . import blackbox as _blackbox
            if _blackbox._active:
                _blackbox.dump(trigger="preempt",
                               reason=f"preempted ({e.origin}) at step "
                                      f"{e.step}", step=e.step)
            if exit_on_preempt:
                _event("preempt_exit")
                raise SystemExit(RESUME_EXIT_CODE)
            if resume_on_preempt and state is not None and state.exists():
                if restarts >= budget:
                    _event("restart_budget_exhausted")
                    raise
                restarts += 1
                # the whole resume (bundle restore + re-entry) is
                # restart badput; restart outranks the nested restore
                # claim so the ledger counts the downtime once
                tok = (_goodput.begin("restart")
                       if _goodput._active else None)
                try:
                    state.load_latest_valid()
                    prev_step = state.step
                    _event("preempt_resume")
                    clear_preempt()
                finally:
                    _goodput.end(tok)
                continue
            raise
        except WorkerLost as e:
            from . import blackbox as _blackbox
            if _blackbox._active:
                _blackbox.dump(trigger="worker_lost",
                               reason=f"WorkerLost({e.op}): {e}", exc=e)
            # a healthy-progress window between faults forgives the budget:
            # N transient faults spread over days should not add up to the
            # same death sentence as N faults in a tight crash loop
            cur = state.step if state is not None else None
            if (window > 0 and cur is not None and prev_step is not None
                    and cur - prev_step >= window):
                restarts = 0
                _event("restart_budget_reset")
            if restarts >= budget:
                _event("restart_budget_exhausted")
                raise
            restarts += 1
            _event("worker_lost", op=e.op)
            tok = _goodput.begin("restart") if _goodput._active else None
            try:
                if state is not None and state.exists():
                    state.load()
                    prev_step = state.step
                _event("restart")
                clear_preempt()
            finally:
                _goodput.end(tok)
