"""gluon.metric.

Counterpart of ``mxnet_tpu/gluon/metric.py``: ``EvalMetric`` and the
registry (``create``, names and aliases as the reference registers them),
``Accuracy``, ``TopKAccuracy``, ``MAE``, ``MSE``, ``RMSE``,
``CrossEntropy``, ``Perplexity``, ``F1``, ``Fbeta``, ``MCC``,
``PearsonCorrelation``, ``PCC``, ``BinaryAccuracy``,
``MeanPairwiseDistance``, ``MeanCosineSimilarity``, ``Loss``, ``Torch``,
``CompositeEvalMetric``, ``CustomMetric`` and ``np``. Labels and
predictions are tensors, ``mx.np`` arrays or host arrays.

Accuracy, TopKAccuracy, MAE, MSE, RMSE, CrossEntropy, Perplexity, Loss and
Torch compute a batch's statistic in one torch function,
``_device_stats(label, pred) -> (sum, count)``: ``update`` folds it in with
one host read a batch, and ``defer(window)``'s sync-free view for the step
loop pushes it as device scalars into a ``pipeline.DeferredWindow``, read
only at ``get()`` / ``drain()`` or when the window overflows, so the two
agree by construction. The other metrics read each batch on the host
(numpy), as the reference does, and their deferred view updates eagerly.
The reference has device statistics for Accuracy, Loss, MSE, RMSE and MAE
only; here TopKAccuracy and CrossEntropy / Perplexity have them too, so
BERT's perplexity and ResNet's top-5 accuracy read nothing on a step.
"""
from __future__ import annotations

import numpy as onp
import torch

from ..base import MXNetError

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "MAE", "MSE", "RMSE",
           "CrossEntropy", "Perplexity", "F1", "Fbeta", "MCC",
           "PearsonCorrelation", "PCC", "BinaryAccuracy",
           "MeanPairwiseDistance", "MeanCosineSimilarity", "Loss", "Torch",
           "CompositeEvalMetric", "CustomMetric", "create", "np",
           "register", "check_label_shapes"]

_registry: dict[str, type] = {}


def register(name=None):
    """Register a metric class under ``name`` (its lower-cased class name
    by default)."""
    def deco(klass):
        _registry[(name or klass.__name__).lower()] = klass
        return klass
    return deco


def _as_np(x):
    """A batch leaf as a numpy array (bf16 widened to fp32)."""
    x = getattr(x, "_data", x)
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return onp.asarray(x)


def _dev(x, like=None):
    """A batch leaf as a tensor, without a host read (on ``like``'s
    device when it comes from the host; bf16 and fp16 widened to fp32)."""
    x = getattr(x, "_data", x)
    if isinstance(x, torch.Tensor):
        x = x.detach()
    else:
        x = torch.as_tensor(onp.asarray(x),
                            device=None if like is None else like.device)
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    return x


def _listify(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def check_label_shapes(labels, preds, shape=False):
    if not shape and len(labels) != len(preds):
        raise MXNetError(
            f"label/pred count mismatch: {len(labels)} vs {len(preds)}")


class EvalMetric:
    """Base metric (reference: metric.py ``EvalMetric``)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def update_dict(self, label, pred):
        self.update(list(label.values()), list(pred.values()))

    def defer(self, window=None):
        """The sync-free view of this metric for the step loop (reference:
        metric.py ``defer``): it shares this metric's accumulators."""
        return _DeferredMetric(self, window)

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class _DeferredMetric:
    """What ``EvalMetric.defer()`` returns: ``update`` pushes device
    statistics into a ``DeferredWindow`` (eager where the metric has
    none); ``get`` / ``get_name_value`` drain first; ``reset`` drops the
    pending values without reading them; other attributes are the
    wrapped metric's."""

    def __init__(self, base, window=None):
        from .. import pipeline as _pipeline
        self._base = base
        self._window = _pipeline.DeferredWindow(window)

    def _apply(self, stats):
        s, n = stats
        self._base.sum_metric += s
        self._base.num_inst += int(n)

    def update(self, labels, preds):
        base = self._base
        if not isinstance(base, _DeviceStatMetric):
            base.update(labels, preds)
            return
        for label, pred in base._pairs(labels, preds):
            self._window.push(base._device_stats(label, pred), self._apply)

    def update_dict(self, label, pred):
        self.update(list(label.values()), list(pred.values()))

    def drain(self):
        """Fold every pending batch into the wrapped metric."""
        self._window.drain()

    def get(self):
        self.drain()
        return self._base.get()

    def get_name_value(self):
        self.drain()
        return self._base.get_name_value()

    def reset(self):
        self._window.clear()
        self._base.reset()

    def __getattr__(self, name):
        return getattr(self._base, name)

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class _DeviceStatMetric(EvalMetric):
    """A metric whose batch statistic is one torch function,
    ``_device_stats(label, pred) -> (sum, count)``, shared by the eager
    ``update`` (one host read a batch) and the deferred view (none)."""

    def _pairs(self, labels, preds):
        return zip(_listify(labels), _listify(preds))

    def update(self, labels, preds):
        for label, pred in self._pairs(labels, preds):
            s, n = self._device_stats(label, pred)
            self.sum_metric += float(s)
            self.num_inst += int(n)


@register("acc")
@register()
class Accuracy(_DeviceStatMetric):
    """Share of predictions (argmax along ``axis`` of scores) equal to the
    labels (reference: metric.py ``Accuracy``)."""

    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def _pairs(self, labels, preds):
        labels, preds = _listify(labels), _listify(preds)
        check_label_shapes(labels, preds)
        return zip(labels, preds)

    def _device_stats(self, label, pred):
        pred = _dev(pred)
        label = _dev(label, pred)
        if pred.ndim > label.ndim:
            pred = pred.argmax(self.axis)
        pred, label = pred.long().reshape(-1), label.long().reshape(-1)
        n = label.shape[0]
        return (pred[:n] == label[:n]).sum(), n


@register("top_k_accuracy")
@register()
class TopKAccuracy(_DeviceStatMetric):
    """Share of rows whose label is among the ``top_k`` highest scores
    (reference: metric.py ``TopKAccuracy``, ``argsort()[:, -k:]``). The
    sort is stable, so a tie on the k-th score goes to the higher class
    index; the reference's numpy sort leaves that order unspecified."""

    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def _device_stats(self, label, pred):
        pred = _dev(pred)
        label = _dev(label, pred).long().reshape(-1, 1)
        idx = pred.argsort(dim=-1, stable=True)[:, -self.top_k:]
        return (idx == label).any(dim=-1).sum(), label.shape[0]


@register()
class MAE(_DeviceStatMetric):
    """Mean absolute error (reference: metric.py ``MAE``)."""

    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def _device_stats(self, label, pred):
        pred = _dev(pred)
        label = _dev(label, pred)
        n = label.shape[0]
        return (label.reshape(pred.shape) - pred).abs().mean() * n, n


@register()
class MSE(_DeviceStatMetric):
    """Mean squared error (reference: metric.py ``MSE``)."""

    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def _device_stats(self, label, pred):
        pred = _dev(pred)
        label = _dev(label, pred)
        n = label.shape[0]
        return ((label.reshape(pred.shape) - pred) ** 2).mean() * n, n


@register()
class RMSE(MSE):
    """Root mean squared error (reference: metric.py ``RMSE``)."""

    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, (self.sum_metric / self.num_inst) ** 0.5


@register("ce")
@register()
class CrossEntropy(_DeviceStatMetric):
    """``-log(p[label] + eps)`` of probability rows (reference: metric.py
    ``CrossEntropy``)."""

    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def _device_stats(self, label, pred):
        pred = _dev(pred)
        label = _dev(label, pred).reshape(-1).long()
        prob = pred[torch.arange(label.shape[0], device=pred.device), label]
        return (-torch.log(prob + self.eps)).sum(), label.shape[0]


@register()
class Perplexity(CrossEntropy):
    """``exp`` of the mean cross-entropy (reference: metric.py
    ``Perplexity``; ``ignore_label`` and ``axis`` are kept and, as there,
    not read)."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(onp.exp(self.sum_metric / self.num_inst))


def _binary(label, pred):
    label, pred = _as_np(label), _as_np(pred)
    if pred.ndim > 1:
        pred = pred.argmax(axis=-1)
    return label.ravel(), pred.ravel()


@register()
class F1(EvalMetric):
    """F1 (``Fbeta`` with its ``beta``) over the binary confusion counts
    (reference: metric.py ``F1``)."""

    beta = 1.0

    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _binary(label, pred)
            self._tp += float(((pred == 1) & (label == 1)).sum())
            self._fp += float(((pred == 1) & (label == 0)).sum())
            self._fn += float(((pred == 0) & (label == 1)).sum())
            self.num_inst += label.shape[0]

    def get(self):
        prec = self._tp / max(self._tp + self._fp, 1e-12)
        rec = self._tp / max(self._tp + self._fn, 1e-12)
        b2 = self.beta ** 2
        return self.name, (1 + b2) * prec * rec / max(b2 * prec + rec,
                                                      1e-12)


@register()
class MCC(EvalMetric):
    """Matthews correlation over the binary confusion counts (reference:
    metric.py ``MCC``)."""

    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = self._tn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _binary(label, pred)
            self._tp += float(((pred == 1) & (label == 1)).sum())
            self._fp += float(((pred == 1) & (label == 0)).sum())
            self._fn += float(((pred == 0) & (label == 1)).sum())
            self._tn += float(((pred == 0) & (label == 0)).sum())
            self.num_inst += label.shape[0]

    def get(self):
        tp, fp, fn, tn = self._tp, self._fp, self._fn, self._tn
        denom = ((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)) ** 0.5
        return self.name, (tp * tn - fp * fn) / denom if denom > 0 else 0.0


@register()
class PearsonCorrelation(EvalMetric):
    """Pearson correlation of every label and prediction seen (reference:
    metric.py ``PearsonCorrelation``)."""

    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._labels, self._preds = [], []

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            self._labels.append(_as_np(label).ravel())
            self._preds.append(_as_np(pred).ravel())
            self.num_inst += 1

    def get(self):
        if not self._labels:
            return self.name, float("nan")
        return self.name, float(onp.corrcoef(
            onp.concatenate(self._labels), onp.concatenate(self._preds))[0, 1])


@register()
class Fbeta(F1):
    """``(1 + b^2) P R / (b^2 P + R)`` (reference: metric.py ``Fbeta``)."""

    def __init__(self, name="fbeta", beta=1, **kwargs):
        super().__init__(name=name, **kwargs)
        self.beta = float(beta)


@register()
class BinaryAccuracy(EvalMetric):
    """Accuracy of scores against ``threshold`` (reference: metric.py
    ``BinaryAccuracy``)."""

    def __init__(self, name="binary_accuracy", threshold=0.5, **kwargs):
        super().__init__(name, **kwargs)
        self.threshold = threshold

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            hard = (pred > self.threshold).astype(label.dtype)
            self.sum_metric += float((hard.ravel() == label.ravel()).sum())
            self.num_inst += label.size


@register()
class MeanPairwiseDistance(EvalMetric):
    """Mean per-sample Lp distance (reference: metric.py
    ``MeanPairwiseDistance``)."""

    def __init__(self, name="mpd", p=2, **kwargs):
        super().__init__(name, **kwargs)
        self.p = p

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            if label.ndim == 1:
                label, pred = label[None], pred[None]
            diff = (onp.abs(pred - label) ** self.p).reshape(
                label.shape[0], -1).sum(axis=1) ** (1.0 / self.p)
            self.sum_metric += float(diff.sum())
            self.num_inst += label.shape[0]


@register()
class MeanCosineSimilarity(EvalMetric):
    """Mean cosine similarity along the last axis (reference: metric.py
    ``MeanCosineSimilarity``)."""

    def __init__(self, name="cos_sim", eps=1e-8, **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            if label.ndim == 1:
                label, pred = label[None], pred[None]
            num = (label * pred).sum(axis=-1)
            den = onp.maximum(onp.linalg.norm(label, axis=-1)
                              * onp.linalg.norm(pred, axis=-1), self.eps)
            sim = num / den
            self.sum_metric += float(sim.sum())
            self.num_inst += sim.size


@register()
class PCC(EvalMetric):
    """Multiclass Pearson correlation from the confusion matrix
    (reference: metric.py ``PCC``)."""

    def __init__(self, name="pcc", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._cm = onp.zeros((0, 0), dtype=onp.float64)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _binary(label, pred)
            label, pred = label.astype(onp.int64), pred.astype(onp.int64)
            if label.size and (label.min() < 0 or pred.min() < 0):
                raise MXNetError(
                    "PCC requires non-negative class ids (negative "
                    "ignore-markers would wrap into the confusion matrix)")
            k = int(max(label.max(), pred.max())) + 1
            if k > self._cm.shape[0]:
                cm = onp.zeros((k, k), dtype=onp.float64)
                cm[:self._cm.shape[0], :self._cm.shape[0]] = self._cm
                self._cm = cm
            onp.add.at(self._cm, (label, pred), 1.0)
            self.num_inst += label.shape[0]

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        cm = self._cm
        s, c = cm.sum(), onp.trace(cm)
        t, p = cm.sum(axis=1), cm.sum(axis=0)
        den = onp.sqrt(max(s * s - (p @ p), 0.0)) \
            * onp.sqrt(max(s * s - (t @ t), 0.0))
        if den <= 0:
            return self.name, 0.0
        return self.name, float((c * s - t @ p) / den)


@register("loss")
class Loss(_DeviceStatMetric):
    """Mean of the given losses; labels are not read (reference:
    metric.py ``Loss``)."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def _pairs(self, _labels, preds):
        return ((None, pred) for pred in _listify(preds))

    def _device_stats(self, _label, pred):
        pred = _dev(pred)
        return pred.sum(), pred.numel()


@register()
class Torch(Loss):
    """``Loss`` under the name "torch" (reference: metric.py ``Torch``)."""

    def __init__(self, name="torch", **kwargs):
        super().__init__(name=name, **kwargs)


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together (reference: metric.py
    ``CompositeEvalMetric``)."""

    def __init__(self, metrics=None, name="composite", **kwargs):
        self.metrics = list(metrics or [])
        super().__init__(name, **kwargs)

    def add(self, metric):
        self.metrics.append(create(metric))

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            name, value = m.get()
            names.append(name)
            values.append(value)
        return names, values


class CustomMetric(EvalMetric):
    """A metric of ``feval(label, pred)`` on numpy arrays, which returns a
    value or a ``(sum, count)`` pair (reference: metric.py
    ``CustomMetric``)."""

    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            v = self._feval(_as_np(label), _as_np(pred))
            if isinstance(v, tuple):
                s, n = v
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += v
                self.num_inst += 1


def np(numpy_feval, name="custom", allow_extra_outputs=False):
    """A :class:`CustomMetric` of a numpy function."""
    return CustomMetric(numpy_feval, name, allow_extra_outputs)


def create(metric, *args, **kwargs):
    """A metric by name, callable, list (composite) or instance."""
    if isinstance(metric, EvalMetric):
        return metric
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, list):
        return CompositeEvalMetric([create(m) for m in metric])
    klass = _registry.get(str(metric).lower())
    if klass is None:
        raise MXNetError(f"unknown metric {metric!r} (registered: "
                         f"{sorted(_registry)})")
    return klass(*args, **kwargs)
