"""Fused sparse softmax cross-entropy.

Counterpart of ``mxnet_tpu/ops/xent.py`` ``sparse_softmax_xent`` (a
``jax.custom_vjp`` in XLA there, not a Pallas kernel), as a
``torch.autograd.Function`` in plain PyTorch:

- forward: ``logsumexp(x) - x[label]`` in fp32, reading the logits in
  their own dtype and gathering ``N`` picked values (no (N, V) fp32
  log-softmax is kept);
- backward: ``(softmax(x) - onehot(label)) * g`` in the logits' dtype,
  rebuilt from the saved ``lse``;
- out-of-range labels clip to the nearest class, as ``_clip_labels``
  (``npx.pick(mode='clip')``) does. Labels get no gradient.

``chunked_lm_xent`` is not part of this slice of the port.
"""
from __future__ import annotations

import torch

__all__ = ["sparse_softmax_xent"]


def _clip_labels(labels, n_classes):
    return labels.long().clamp(0, n_classes - 1)


class _SparseSoftmaxXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels, axis):
        axis = axis % logits.ndim
        idx = _clip_labels(labels, logits.shape[axis]).unsqueeze(axis)
        lse = torch.logsumexp(logits.float(), dim=axis)
        picked = logits.gather(axis, idx).squeeze(axis)
        ctx.save_for_backward(logits, idx, lse)
        ctx.axis = axis
        return lse - picked.float()

    @staticmethod
    def backward(ctx, g):
        logits, idx, lse = ctx.saved_tensors
        axis = ctx.axis
        dx = (logits.float() - lse.unsqueeze(axis)).exp_()
        dx.scatter_add_(axis, idx, torch.full(idx.shape, -1.0,
                                              device=dx.device))
        dx.mul_(g.float().unsqueeze(axis))
        return dx.to(logits.dtype), None, None


def sparse_softmax_xent(logits, labels, axis=-1):
    """Per-element ``-log softmax(logits)[labels]`` along ``axis``.

    logits: (..., V, ...) float tensor; labels: integer tensor of
    ``logits.shape`` minus ``axis``. Returns float32 losses of the label
    shape. Gradients flow to ``logits`` only."""
    return _SparseSoftmaxXent.apply(logits, labels, axis)
