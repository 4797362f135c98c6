"""gluon.loss (training slice).

Counterpart of ``mxnet_tpu/gluon/loss.py``: the ``Loss`` base (mean over
every axis but the batch axis, ``_apply_weighting``) and
``SoftmaxCrossEntropyLoss``, whose sparse-label path on logits goes
through the fused ``ops.xent.sparse_softmax_xent``. A loss is per sample,
of shape ``(batch,)``: ``autograd.backward`` seeds it with ones and
``Trainer.step(batch)`` divides by the batch, as in the reference. The
other losses wait for later slices.
"""
from __future__ import annotations

import torch

from .. import amp
from ..ops.xent import sparse_softmax_xent
from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    """Base loss (reference: loss.py ``Loss``)."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean(self, loss):
        axes = tuple(i for i in range(loss.ndim) if i != self._batch_axis)
        if not axes:
            return loss
        loss, = amp._maybe_cast_op_inputs("mean", (loss,))
        return loss.mean(dim=axes)


class SoftmaxCrossEntropyLoss(Loss):
    """Reference: loss.py ``SoftmaxCrossEntropyLoss`` (sparse or dense
    labels, logits or log-probabilities)."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits and self._sparse_label:
            # dispatched under its own name, in no AMP list: the logits keep
            # their dtype (the op sums in fp32 and returns fp32)
            pred, = amp._maybe_cast_op_inputs("sparse_softmax_xent", (pred,))
            loss = sparse_softmax_xent(pred, label, self._axis)
        else:
            if not self._from_logits:
                pred, = amp._maybe_cast_op_inputs("log_softmax", (pred,))
                pred = torch.log_softmax(pred, dim=self._axis)
            if self._sparse_label:
                # npx.pick(mode='clip'): out-of-range labels clamp
                idx = label.long().clamp(0, pred.shape[self._axis] - 1)
                loss = -pred.gather(self._axis, idx.unsqueeze(self._axis)) \
                    .squeeze(self._axis)
            else:
                loss = -(pred * label.reshape(pred.shape)).sum(dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)
