"""Pluggable per-batch logic for the Estimator.

Counterpart of ``mxnet_tpu/gluon/contrib/estimator/batch_processor.py``
(reference parity: gluon/contrib/estimator/batch_processor.py:28, the
fit_batch / evaluate_batch hooks). The hooks take the whole batch, as the
JAX package's do.
"""
from __future__ import annotations

from .... import autograd

__all__ = ["BatchProcessor"]


class BatchProcessor:
    """Default minibatch step; subclass and override to customize."""

    @staticmethod
    def _get_data_and_label(batch, batch_axis=0):  # noqa: ARG004
        return batch[0], batch[1]

    def fit_batch(self, estimator, train_batch, batch_axis=0):
        """Forward + backward on one batch; the optimizer step happens in
        GradientUpdateHandler at batch_end (reference ordering)."""
        data, label = self._get_data_and_label(train_batch, batch_axis)
        with autograd.record():
            pred = estimator.net(data)
            loss = estimator.loss(pred, label)
        autograd.backward(loss)
        return [data], [label], [pred], [loss]

    def evaluate_batch(self, estimator, val_batch, batch_axis=0):
        data, label = self._get_data_and_label(val_batch, batch_axis)
        pred = estimator.val_net(data)
        loss = estimator.val_loss(pred, label)
        return [data], [label], [pred], [loss]
