"""gluon.loss.

Counterpart of ``mxnet_tpu/gluon/loss.py``: the ``Loss`` base (mean over
every axis but the batch axis, ``_apply_weighting``) and the reference's
fifteen losses with their arguments (``weight``, ``batch_axis``,
``sample_weight``): ``L2Loss``, ``L1Loss``, ``HuberLoss``,
``SigmoidBinaryCrossEntropyLoss`` (``from_sigmoid``, ``pos_weight``),
``SoftmaxCrossEntropyLoss`` (sparse or dense labels: label smoothing is a
dense label), ``KLDivLoss``, ``CTCLoss``, ``HingeLoss``,
``SquaredHingeLoss``, ``LogisticLoss``, ``TripletLoss``,
``CosineEmbeddingLoss``, ``PoissonNLLLoss`` and ``SDMLLoss``, and the
``SoftmaxCELoss`` / ``SigmoidBCELoss`` aliases, each as the reference
computes it. The softmax loss's sparse-label path on logits goes through
the fused ``ops.xent.sparse_softmax_xent`` (one op under the host planes'
hooks, named ``sparse_softmax_xent`` as the reference's ``_invoke`` names
it). ``CTCLoss`` is the reference's ``optax.ctc_loss`` (blank 0, log(0) as
-1e5, labels padded with 0 where no lengths are given) written out in
PyTorch. A loss is per sample, of shape ``(batch,)``:
``autograd.backward`` seeds it with ones and ``Trainer.step(batch)``
divides by the batch, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import _hooks, amp
from ..ops.xent import sparse_softmax_xent
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "HuberLoss",
           "SigmoidBinaryCrossEntropyLoss", "SigmoidBCELoss",
           "SoftmaxCrossEntropyLoss", "SoftmaxCELoss", "KLDivLoss",
           "CTCLoss", "HingeLoss", "SquaredHingeLoss", "LogisticLoss",
           "TripletLoss", "CosineEmbeddingLoss", "PoissonNLLLoss",
           "SDMLLoss"]


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
            if _hooks.on:
                loss = _hooks.call(sparse_softmax_xent, "sparse_softmax_xent",
                                   (pred, label, self._axis), {})
            else:
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


SoftmaxCELoss = SoftmaxCrossEntropyLoss


def _softplus_neg_abs(x):
    """``log(1 + exp(-|x|))``, as the reference writes it."""
    return torch.log(1 + torch.exp(-x.abs()))


class L2Loss(Loss):
    """``weight / 2 * (label - pred)^2`` (reference: loss.py ``L2Loss``)."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean(loss)


class L1Loss(Loss):
    """``|label - pred|`` (reference: loss.py ``L1Loss``)."""

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)


class HuberLoss(Loss):
    """Smooth L1 with threshold ``rho`` (reference: loss.py
    ``HuberLoss``)."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        err = torch.abs(label.reshape(pred.shape) - pred)
        loss = torch.where(err > self._rho, err - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(err))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy on logits (the stable form) or on
    probabilities (``from_sigmoid``), ``pos_weight`` weighting the
    positive term (reference: loss.py ``SigmoidBinaryCrossEntropyLoss``)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.clamp(pred, min=0) - pred * label \
                    + _softplus_neg_abs(pred)
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _softplus_neg_abs(pred) + torch.clamp(-pred, min=0))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label
                         + torch.log(1 - pred + eps) * (1 - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight
                         + torch.log(1 - pred + eps) * (1 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label + 1e-12) - pred)``, ``pred`` log-probabilities
    (``from_logits``) or logits (reference: loss.py ``KLDivLoss``)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)


def ctc_loss(logits, logit_paddings, labels, label_paddings, blank_id=0,
             log_epsilon=-1e5):
    """Per-sequence CTC loss (B,) of ``logits`` (B, T, K): the forward
    recursion of ``optax.ctc_loss`` (which the reference calls), blank and
    label alphas in log space with ``log_epsilon`` for log(0); padded
    frames (``logit_paddings`` 1) keep the alphas, padded labels
    (``label_paddings`` 1) must trail each row."""
    b, t_max, k = logits.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    dt = logprobs.dtype
    labellens = n - label_paddings.sum(dim=1).to(torch.int64)
    repeat = (labels[:, :-1] == labels[:, 1:]).to(dt)
    repeat = F.pad(repeat, (0, 1))
    lp_phi = logprobs[:, :, blank_id:blank_id + 1].transpose(0, 1)
    one_hot = F.one_hot(labels.long(), k).to(dt)
    lp_emit = torch.einsum("btk,bnk->btn", logprobs, one_hot).transpose(0, 1)
    phi = torch.full((b, n + 1), log_epsilon, dtype=dt, device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    emit = torch.full((b, n), log_epsilon, dtype=dt, device=logits.device)
    pads = logit_paddings.to(dt).transpose(0, 1)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], dim=-1)

    for step in range(t_max):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit[step],
                               emit + lp_emit[step])
        next_phi = update_phi(prev_phi + lp_phi[step],
                              emit + lp_phi[step]
                              + log_epsilon * (1.0 - repeat))
        pad = pads[step].reshape(b, 1)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, emit)
    pick = F.one_hot(labellens, n + 1).to(dt)
    return -(last * pick).sum(dim=1)


class CTCLoss(Loss):
    """Connectionist temporal classification (reference: loss.py
    ``CTCLoss``, over ``optax.ctc_loss`` with blank 0): ``pred`` (N, T, C)
    logits ("NTC", or "TNC"), ``label`` (N, L) ("NT", or "TN"); without
    ``label_lengths`` a label of 0 is padding. Per-sequence losses,
    ``weight`` and ``sample_weight`` applied, no mean."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        super().__init__(weight, 0)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "TNC":
            pred = pred.transpose(0, 1)
        if self._label_layout == "TN":
            label = label.transpose(0, 1)
        b, t = pred.shape[0], pred.shape[1]
        f32 = torch.float32
        if pred_lengths is None:
            lp = torch.zeros((b, t), dtype=f32, device=pred.device)
        else:
            lp = (torch.arange(t, device=pred.device)[None, :]
                  >= torch.as_tensor(pred_lengths, device=pred.device)
                  [:, None]).to(f32)
        n = label.shape[1]
        if label_lengths is not None:
            lpad = (torch.arange(n, device=pred.device)[None, :]
                    >= torch.as_tensor(label_lengths, device=pred.device)
                    [:, None]).to(f32)
        else:
            lpad = (label == 0).to(f32)
        loss = ctc_loss(pred, lp, label.to(torch.int32), lpad)
        return _apply_weighting(loss, self._weight, sample_weight)


class HingeLoss(Loss):
    """``max(margin - pred * label, 0)`` (reference: loss.py
    ``HingeLoss``)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.clamp(self._margin - pred * label.reshape(pred.shape),
                           min=0)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)


class SquaredHingeLoss(Loss):
    """``max(margin - pred * label, 0)^2`` (reference: loss.py
    ``SquaredHingeLoss``)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(torch.clamp(
            self._margin - pred * label.reshape(pred.shape), min=0))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)


class LogisticLoss(Loss):
    """Logistic loss on ``signed`` (-1/1) or ``binary`` (0/1) labels
    (reference: loss.py ``LogisticLoss``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.clamp(pred, min=0) - pred * label \
            + _softplus_neg_abs(pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)


class TripletLoss(Loss):
    """``max(sum((pred - pos)^2 - (pred - neg)^2) + margin, 0)`` over the
    non-batch axes (reference: loss.py ``TripletLoss``)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        loss = torch.sum(torch.square(pred - positive)
                         - torch.square(pred - negative),
                         dim=tuple(range(1, pred.ndim)))
        loss = torch.clamp(loss + self._margin, min=0)
        return _apply_weighting(loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """``1 - cos`` for label 1, ``max(cos - margin, 0)`` otherwise
    (reference: loss.py ``CosineEmbeddingLoss``)."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        eps = 1e-12
        dot = torch.sum(input1 * input2, dim=-1)
        n1 = torch.sqrt(torch.sum(torch.square(input1), dim=-1) + eps)
        n2 = torch.sqrt(torch.sum(torch.square(input2), dim=-1) + eps)
        cos = dot / (n1 * n2)
        label = label.reshape(cos.shape)
        loss = torch.where(label == 1, 1 - cos,
                           torch.clamp(cos - self._margin, min=0))
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood, ``pred`` a log-rate
    (``from_logits``) or a rate, with the Stirling term
    (``compute_full``); the mean over every element (reference: loss.py
    ``PoissonNLLLoss``)."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = target.reshape(pred.shape)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = target * torch.log(target + 1e-12) - target \
                + 0.5 * torch.log(2 * math.pi * (target + 1e-12))
            loss = loss + torch.where(target > 1, stirling,
                                      torch.zeros_like(target))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class SDMLLoss(Loss):
    """Batchwise smoothed deep metric learning loss (reference: loss.py
    ``SDMLLoss``): rows of ``x1`` and ``x2`` are positive pairs, the other
    rows in-batch negatives; KL between the softmax of the negative
    squared distances and a smoothed identity."""

    def __init__(self, smoothing_parameter=0.3, weight=1., batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis)
        self.kl_loss = KLDivLoss(from_logits=True)
        self.smoothing_parameter = smoothing_parameter

    def forward(self, x1, x2):
        batch_size = x1.shape[0]
        if batch_size < 2:
            raise ValueError("SDMLLoss needs batch_size >= 2 (in-batch "
                             f"negatives); got {batch_size}")
        distances = torch.square(x1.unsqueeze(1) - x2.unsqueeze(0)).sum(2)
        gold = torch.eye(batch_size, dtype=x1.dtype, device=x1.device)
        s = self.smoothing_parameter
        labels = gold * (1 - s) + (1 - gold) * s / (batch_size - 1)
        return self.kl_loss(torch.log_softmax(-distances, dim=1), labels)
