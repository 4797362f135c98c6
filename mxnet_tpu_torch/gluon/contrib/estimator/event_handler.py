"""Estimator event handlers (reference: gluon/contrib/estimator/
event_handler.py; counterpart of
``mxnet_tpu/gluon/contrib/estimator/event_handler.py``)."""
from __future__ import annotations

import logging
import os
import time

import numpy as onp


class EventHandler:
    """Common base (reference event_handler.py EventHandler); handlers
    may set ``priority`` — lower runs earlier within an event."""

    priority = 0


class TrainBegin(EventHandler):
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd(EventHandler):
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin(EventHandler):
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd(EventHandler):
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin(EventHandler):
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd(EventHandler):
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop on max epoch/batch (reference: event_handler.py StoppingHandler)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch >= self.max_batch:
            self.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch >= self.max_epoch:
            self.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    def __init__(self, metrics, priority=-1000):
        self.metrics = metrics or []
        self.priority = priority

    def epoch_begin(self, estimator, *args, **kwargs):
        for m in self.metrics:
            m.reset()

    def batch_end(self, estimator, *args, **kwargs):
        pred = kwargs.get("pred")
        label = kwargs.get("label")
        loss = kwargs.get("loss")
        for m in self.metrics:
            from ...metric import Loss as LossMetric
            # deferred wrappers (EvalMetric.defer) proxy a base metric;
            # dispatch on the wrapped type
            if isinstance(getattr(m, "_base", m), LossMetric):
                m.update(None, loss)
            else:
                m.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Periodic validation (reference: event_handler.py:160)."""

    def __init__(self, val_data, eval_fn, epoch_period=1, batch_period=None,
                 priority=-1000):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_batch = 0
        self.current_epoch = 0
        self.priority = priority

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self.eval_fn(self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self.eval_fn(self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchEnd):
    def __init__(self, log_interval="epoch", metrics=None, priority=float("inf")):
        self.log_interval = log_interval
        self.metrics = metrics or []
        self.priority = priority
        self.batch_index = 0
        self.logger = logging.getLogger("estimator")

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()

    def train_end(self, estimator, *args, **kwargs):
        self.logger.info("training done in %.1fs",
                         time.time() - self.train_start)

    def batch_end(self, estimator, *args, **kwargs):
        self.batch_index += 1
        if isinstance(self.log_interval, int) and \
                self.batch_index % self.log_interval == 0:
            msg = " ".join(f"{n}={v:.4f}" for m in self.metrics
                           for n, v in m.get_name_value())
            self.logger.info("[batch %d] %s", self.batch_index, msg)

    def epoch_end(self, estimator, *args, **kwargs):
        msg = " ".join(f"{n}={v:.4f}" for m in self.metrics
                       for n, v in m.get_name_value())
        from .... import telemetry
        if telemetry.active():
            tele = telemetry.summary_line()
            if tele:
                msg = (msg + " | " if msg else "") + tele
        self.logger.info("[epoch end] %s", msg)


class TelemetryHandler(TrainBegin, BatchEnd, EpochEnd, TrainEnd):
    """Drives an ``mx.telemetry.TrainingTelemetry`` reporter over the fit
    loop: per-batch JSONL step records (with the first loss value when the
    fit loop passes one), an epoch marker per epoch, and the final run
    report (kept on ``self.run_report`` after training).  Constructing the
    reporter at ``train_begin`` enables the metrics registry, so adding
    this one handler turns on the whole observability layer for a run.

    priority inf: runs last within each event, after the optimizer step
    and metric updates it is reporting on."""

    def __init__(self, path=None, interval=None, run_id=None,
                 priority=float("inf")):
        self.path = path
        self.interval = interval
        self.run_id = run_id
        self.priority = priority
        self.reporter = None
        self.run_report = None
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        from .... import telemetry
        self.current_epoch = 0
        self.reporter = telemetry.TrainingTelemetry(
            path=self.path, interval=self.interval, run_id=self.run_id)

    def batch_end(self, estimator, *args, **kwargs):
        if self.reporter is None:
            return
        fields = {}
        loss = kwargs.get("loss")
        # only pay the device->host loss fetch on steps the reporter
        # will actually emit — it drops the field on every other step,
        # so fetching per batch stalled the pipeline for nothing
        if loss is not None and \
                (self.reporter._steps + 1) % self.reporter._interval == 0:
            if isinstance(loss, (list, tuple)):
                loss = loss[0] if loss else None
            try:
                fields["loss"] = float(
                    loss.mean().item() if getattr(loss, "ndim", 0) else loss)
            except (TypeError, ValueError):
                pass
        self.reporter.step(**fields)

    @staticmethod
    def _drain(estimator):
        # flush device-side accumulators (deferred grad norms) into the
        # registry before the numbers are read — the epoch boundary is
        # exactly where the sync-free step loop pays its host syncs
        trainer = getattr(estimator, "trainer", None)
        if trainer is not None and hasattr(trainer, "drain_telemetry"):
            trainer.drain_telemetry()

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        self._drain(estimator)
        if self.reporter is not None:
            self.reporter.mark("epoch", epoch=self.current_epoch)

    def train_end(self, estimator, *args, **kwargs):
        self._drain(estimator)
        if self.reporter is not None:
            self.run_report = self.reporter.close()
            self.reporter = None


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Periodic model+trainer checkpointing with best-metric tracking
    (reference: event_handler.py:336).

    Robustness beyond the reference: every file is written crash-atomically
    (Block.save_parameters / Trainer.save_states) and gets a ``.sha256``
    sidecar; ``resume_from_checkpoint=True`` restores the newest checkpoint
    whose checksum validates at ``train_begin``, falling back to older ones
    when a checkpoint is torn/corrupt (each rejection is counted in
    ``mx.fault.stats()`` as ``checkpoint.rejected``)."""

    #: every on-disk artifact a checkpoint prefix may own (data + sidecars)
    _SUFFIXES = (".params", ".params.npz", ".states",
                 ".params.sha256", ".params.npz.sha256", ".states.sha256")

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 verbose=0, save_best=False, mode="auto", epoch_period=1,
                 batch_period=None, max_checkpoints=5, resume_from_checkpoint=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.save_best = save_best
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.max_checkpoints = max_checkpoints
        self.resume_from_checkpoint = resume_from_checkpoint
        self.current_epoch = 0
        self.current_batch = 0
        self.best = -onp.inf if mode == "max" else onp.inf
        self.mode = mode
        self.saved = []
        os.makedirs(model_dir, exist_ok=True)

    def _save(self, estimator, tag):
        from .... import serialization
        prefix = os.path.join(self.model_dir, f"{self.model_prefix}-{tag}")
        estimator.net.save_parameters(prefix + ".params")
        if getattr(estimator, "trainer", None) is not None:
            estimator.trainer.save_states(prefix + ".states")
        for suffix in (".params", ".params.npz", ".states"):
            if os.path.exists(prefix + suffix):
                serialization.write_checksum(prefix + suffix)
        self.saved.append(prefix)
        while len(self.saved) > self.max_checkpoints:
            old = self.saved.pop(0)
            for suffix in self._SUFFIXES:
                try:
                    os.remove(old + suffix)
                except OSError:
                    pass

    def train_begin(self, estimator, *args, **kwargs):
        if self.resume_from_checkpoint:
            self._resume(estimator)

    def _epoch_checkpoints(self):
        """(epoch, prefix) for every epoch checkpoint on disk, newest
        first."""
        import re
        pat = re.compile(re.escape(self.model_prefix) + r"-epoch(\d+)\.params$")
        found = []
        for fn in os.listdir(self.model_dir):
            m = pat.match(fn)
            if m:
                found.append((int(m.group(1)),
                              os.path.join(self.model_dir, fn[:-7])))
        return sorted(found, reverse=True)

    def _resume(self, estimator):
        """Restore the newest checkpoint that validates; walk to older ones
        past any torn/corrupt file instead of dying on it."""
        from .... import fault as _fault
        logger = logging.getLogger("estimator")
        for epoch, prefix in self._epoch_checkpoints():
            try:
                estimator.net.load_parameters(prefix + ".params")
                states = prefix + ".states"
                if os.path.exists(states) and \
                        getattr(estimator, "trainer", None) is not None:
                    estimator.trainer.load_states(states)
            except Exception as e:  # noqa: BLE001 - any torn/corrupt artifact
                _fault.record("checkpoint.rejected")
                logger.warning("checkpoint %s rejected (%s); trying older",
                               prefix, e)
                continue
            self.current_epoch = epoch
            # cleanup rotation continues from what survives on disk
            self.saved = [p for _, p in
                          sorted(self._epoch_checkpoints())][-self.max_checkpoints:]
            _fault.record("checkpoint.resume")
            logger.info("resumed from %s (epoch %d)", prefix, epoch)
            return
        logger.info("resume requested but no valid checkpoint in %s",
                    self.model_dir)

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self._save(estimator, f"batch{self.current_batch}")

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self._save(estimator, f"epoch{self.current_epoch}")
        if self.save_best and self.monitor is not None:
            _, value = self.monitor.get()
            better = value > self.best if self.mode == "max" \
                else value < self.best
            if better:
                self.best = value
                self._save(estimator, "best")


class EarlyStoppingHandler(TrainBegin, EpochEnd):
    """Reference: event_handler.py:614."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="auto",
                 baseline=None):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.mode = mode
        self.baseline = baseline
        self.wait = 0
        self.stop_training = False
        self.best = None

    def epoch_end(self, estimator, *args, **kwargs):
        _, value = self.monitor.get()
        if self.best is None:
            self.best = value
            return
        improved = (value > self.best + self.min_delta
                    if self.mode == "max"
                    else value < self.best - self.min_delta)
        if improved:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True


class ResilienceHandler(TrainBegin, BatchEnd, EpochEnd, TrainEnd):
    """Preemption-safe elastic training for the fit loop (no reference
    analog — the reference's CheckpointHandler is epoch-granular and knows
    nothing about signals).

    - ``train_begin``: installs SIGTERM/SIGINT graceful-shutdown handlers,
      builds a ``mx.resilience.TrainState`` over ``estimator.net`` /
      ``estimator.trainer`` / the given ``loader``, and (with
      ``auto_restore``) restores an existing valid bundle so the run
      continues at the exact next batch; a torn bundle is rejected by its
      checksum and counted (``checkpoint.rejected``), never half-loaded.
    - ``batch_end`` (priority -1500: after GradientUpdateHandler's
      optimizer step at -2000, before metric/logging handlers): counts the
      completed step, then — when a preemption signal arrived or the
      ``resilience.preempt`` injection fires — saves the bundle and raises
      ``Preempted``.  The in-flight step has fully finished by then, so
      the bundle resumes with bitwise-identical remaining losses.
    - ``epoch_end``/``train_end``: epoch counter; signal-handler teardown.
    """

    def __init__(self, bundle_path, loader=None, auto_restore=True,
                 priority=-1500):
        self.bundle_path = bundle_path
        self.loader = loader
        self.auto_restore = auto_restore
        self.priority = priority
        self.state = None
        self.resumed = False

    def train_begin(self, estimator, *args, **kwargs):
        from .... import fault as _fault
        from .... import resilience
        resilience.clear_preempt()
        resilience.install_signal_handlers()
        self.state = resilience.TrainState(
            net=estimator.net,
            trainer=getattr(estimator, "trainer", None),
            loader=self.loader, path=self.bundle_path)
        self.resumed = False
        if self.auto_restore and self.state.exists():
            try:
                self.state.load()
                self.resumed = True
                logging.getLogger("estimator").info(
                    "resumed TrainState bundle %s (step %d)",
                    self.bundle_path, self.state.step)
            except Exception as e:  # noqa: BLE001 - torn/corrupt bundle
                _fault.record("checkpoint.rejected")
                logging.getLogger("estimator").warning(
                    "TrainState bundle %s rejected (%s); starting fresh",
                    self.bundle_path, e)

    def batch_end(self, estimator, *args, **kwargs):
        from .... import resilience
        self.state.step += 1
        if resilience.preempt_requested(step=self.state.step):
            path = self.state.save()
            resilience.uninstall_signal_handlers()
            raise resilience.Preempted(path=path, step=self.state.step,
                                       origin="preempt")

    def epoch_end(self, estimator, *args, **kwargs):
        if self.state is not None:
            self.state.epoch += 1

    def train_end(self, estimator, *args, **kwargs):
        from .... import resilience
        resilience.uninstall_signal_handlers()


class GradientUpdateHandler(BatchEnd):
    """Applies the optimizer step at batch end (reference
    event_handler.py:722; priority -2000 so it runs before metric and
    logging handlers that read the post-step state)."""

    def __init__(self, priority=-2000):
        self.priority = priority

    def batch_end(self, estimator, *args, **kwargs):
        # the data batch size, passed by the fit loop, is the correct
        # gradient normalizer (Trainer.step sets rescale_grad = 1/n);
        # loss shapes mislead for mean-reduced losses or batch_axis != 0
        batch_size = kwargs.get("num_samples")
        if not batch_size:
            loss = kwargs.get("loss", [])
            if not isinstance(loss, (list, tuple)):
                loss = [loss]
            batch_size = sum(
                (l.shape[0] if getattr(l, "ndim", 0) else 1) for l in loss)
        estimator.trainer.step(max(batch_size, 1))
