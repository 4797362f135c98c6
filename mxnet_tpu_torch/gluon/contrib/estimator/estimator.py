"""Estimator fit loop (reference: gluon/contrib/estimator/estimator.py;
counterpart of ``mxnet_tpu/gluon/contrib/estimator/estimator.py``).

Architecture mirrors the reference: the minibatch step lives in a
pluggable BatchProcessor (batch_processor.py), the optimizer step in
GradientUpdateHandler at batch_end, and handlers run in ascending
``priority`` order per event (sorted once per fit, not per dispatch).
"""
from __future__ import annotations

import numpy as onp
import torch

from .... import pipeline as _pipeline
from .... import trace as _trace
from ....context import resolve_device
from ....numpy.multiarray import array
from ...metric import Accuracy, Loss as LossMetric
from ...trainer import Trainer
from .batch_processor import BatchProcessor
from .event_handler import (
    GradientUpdateHandler, MetricHandler, StoppingHandler,
)

_EVENTS = ("train_begin", "train_end", "epoch_begin", "epoch_end",
           "batch_begin", "batch_end")
_END = object()


def _place_batch(batch):
    """Ensure every array leaf of ``batch`` is on the current context.
    Leaves already there (a prefetched batch) pass through untouched; only
    host leaves pay a copy (the h2d phase the ``train.step`` span tree
    times), a numpy leaf becoming an ``mx.np`` array."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_place_batch(b) for b in batch)
    if isinstance(batch, onp.ndarray):
        return array(batch, device=resolve_device())
    if getattr(batch, "_data", None) is not None or \
            isinstance(batch, torch.Tensor):
        return _pipeline.maybe_device_put(batch, resolve_device())[0]
    return batch


class Estimator:
    def __init__(self, net, loss, train_metrics=None, val_metrics=None,
                 trainer=None, context=None, device=None,
                 batch_processor=None, val_net=None, val_loss=None):
        self.net = net
        self.loss = loss
        self.val_net = val_net or net
        self.val_loss = val_loss or loss
        self.train_metrics = train_metrics or [Accuracy()]
        if not isinstance(self.train_metrics, list):
            self.train_metrics = [self.train_metrics]
        self.train_metrics.append(LossMetric("train_loss"))
        self.val_metrics = val_metrics
        if self.val_metrics is not None and \
                not isinstance(self.val_metrics, list):
            self.val_metrics = [self.val_metrics]
        self.trainer = trainer or Trainer(
            net.collect_params(), "adam", {"learning_rate": 1e-3})
        self.batch_processor = batch_processor or BatchProcessor()

    def _handlers(self, event_handlers, epochs, batches):
        handlers = list(event_handlers or [])
        stop = StoppingHandler(epochs, batches)
        handlers.append(stop)
        handlers.append(MetricHandler(self.train_metrics))
        if not any(isinstance(h, GradientUpdateHandler) for h in handlers):
            handlers.append(GradientUpdateHandler())
        # per-event dispatch lists, priority-sorted once (the handler set
        # is fixed for the whole fit)
        by_event = {
            ev: sorted((h for h in handlers if getattr(h, ev, None)),
                       key=lambda h: getattr(h, "priority", 0))
            for ev in _EVENTS}
        return by_event, stop

    def fit(self, train_data, val_data=None, epochs=None, event_handlers=None,
            batches=None, batch_axis=0, autotune=False):
        if autotune:
            from ....base import MXNetError
            raise MXNetError("Estimator.fit(autotune=...): mx.autotune is "
                             "not part of the port yet")
        epochs = epochs or (None if batches else 1)
        by_event, stop = self._handlers(event_handlers, epochs, batches)

        def _dispatch(kind, *args, **kwargs):
            for h in by_event[kind]:
                getattr(h, kind)(self, *args, **kwargs)

        _dispatch("train_begin")
        step_no = 0
        while not stop.stop_training:
            _dispatch("epoch_begin")
            batch_iter = iter(train_data)
            while True:
                # step anatomy (spans only while tracing): data_wait ->
                # h2d -> dispatch -> drain. The drain child only notes the
                # deferred-window depth; fetches stay at epoch boundaries,
                # so the loop remains sync-free
                traced = _trace._active
                step_no += traced
                with _trace.span("train.step", category="train",
                                 step=step_no):
                    with _trace.span("train.data_wait", category="train"):
                        batch = next(batch_iter, _END)
                    if batch is _END or stop.stop_training:
                        break
                    with _trace.span("train.h2d", category="train"):
                        batch = _place_batch(batch)
                    _dispatch("batch_begin")
                    with _trace.span("train.dispatch", category="train"):
                        _, label, pred, loss = \
                            self.batch_processor.fit_batch(
                                self, batch, batch_axis)
                        _dispatch("batch_end", pred=pred, label=label,
                                  loss=loss,
                                  num_samples=batch[0].shape[batch_axis])
                    if traced:
                        window = getattr(self.trainer, "_norm_window", None)
                        with _trace.span("train.drain", category="train",
                                         pending=(len(window)
                                                  if window is not None
                                                  else 0)):
                            pass
            _dispatch("epoch_end")
            if epochs is None and batches is None:
                break
        _dispatch("train_end")
        return self

    def quantize(self, calib_data, calib_mode="entropy",
                 num_calib_batches=None, exclude_layers=None,
                 exclude_layers_match=None, logger=None):
        """Post-training calibration hook: calibrate the fitted net over
        ``calib_data`` with the contrib.quantization observers and return
        a new int8 network (also kept on ``self.quantized_net``); the
        original ``self.net`` is untouched."""
        from ....contrib.quantization import quantize_net
        self.quantized_net = quantize_net(
            self.net, calib_data=calib_data, calib_mode=calib_mode,
            num_calib_batches=num_calib_batches,
            exclude_layers=exclude_layers,
            exclude_layers_match=exclude_layers_match, logger=logger)
        return self.quantized_net

    def evaluate(self, val_data, val_metrics=None, batch_axis=0):
        metrics = val_metrics or self.val_metrics or self.train_metrics
        for m in metrics:
            m.reset()
        for batch in val_data:
            _, label, pred, loss = self.batch_processor.evaluate_batch(
                self, batch, batch_axis)
            for m in metrics:
                # dispatch on the wrapped type for deferred metrics
                if isinstance(getattr(m, "_base", m), LossMetric):
                    m.update(None, loss)
                else:
                    m.update(label, pred)
        return metrics
