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

``chunked_lm_xent`` is the LM head's loss ``-log softmax(h @ w.T)[labels]``
without the (N, V) logits: the forward streams vocabulary chunks through
an online logsumexp and picks the label logits, the backward streams them
again for dh and dw (reference: ``jax.custom_vjp`` over ``lax.scan``);
under ``create_graph`` the backward is itself differentiable, as the
reference's VJP is.
Each chunk's logits are fp32 products of the stored values (the
reference's ``preferred_element_type=f32``).
"""
from __future__ import annotations

import math

import torch

__all__ = ["sparse_softmax_xent", "chunked_lm_xent"]


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
        if torch.is_grad_enabled():
            # create_graph: the same values out of place, lse recomputed
            # where autograd sees it, so the second derivative is exact
            xf = logits.float()
            p = (xf - torch.logsumexp(xf, dim=axis).unsqueeze(axis)).exp()
            onehot = torch.zeros_like(p).scatter_(axis, idx, 1.0)
            dx = (p - onehot) * g.float().unsqueeze(axis)
            return dx.to(logits.dtype), None, None
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


def _chunk_logits(h, w, c0, chunk):
    """fp32 logits of rows ``c0:c0+chunk`` of ``w`` (fewer at the end)."""
    return h.float() @ w[c0:c0 + chunk].float().t()


class _ChunkedLMXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, labels, chunk):
        n, v = h.shape[0], w.shape[0]
        lab = labels.long().clamp(0, v - 1)
        m = torch.full((n,), -math.inf, device=h.device)
        s = torch.zeros(n, device=h.device)
        picked = torch.zeros(n, device=h.device)
        for c0 in range(0, v, chunk):
            logits = _chunk_logits(h, w, c0, chunk)
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - m_new) \
                + torch.exp(logits - m_new[:, None]).sum(-1)
            inside = (lab >= c0) & (lab < c0 + logits.shape[1])
            local = (lab - c0).clamp(0, logits.shape[1] - 1)
            got = logits.gather(1, local[:, None])[:, 0]
            picked = torch.where(inside, got, picked)
            m = m_new
        lse = m + torch.log(s)
        ctx.save_for_backward(h, w, lab, lse)
        ctx.chunk = chunk
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        h, w, lab, lse = ctx.saved_tensors
        chunk = ctx.chunk
        create_graph = torch.is_grad_enabled()
        if create_graph:
            # the same values out of place, lse recomputed where autograd
            # sees it, so the second derivative is exact (the reference
            # differentiates its VJP)
            lse = torch.logsumexp(torch.stack([
                torch.logsumexp(_chunk_logits(h, w, c0, chunk), -1)
                for c0 in range(0, w.shape[0], chunk)]), 0)
        gf = g.float()
        dh = torch.zeros(h.shape, device=h.device)
        dws = [] if create_graph else torch.empty(w.shape, device=w.device)
        for c0 in range(0, w.shape[0], chunk):
            logits = _chunk_logits(h, w, c0, chunk)
            p = torch.exp(logits - lse[:, None])
            col = c0 + torch.arange(logits.shape[1], device=h.device)
            onehot = (col[None, :] == lab[:, None]).float()
            dlogits = ((p - onehot) * gf[:, None]).to(h.dtype).float()
            dh = dh + dlogits @ w[c0:c0 + chunk].float()
            if create_graph:
                dws.append(dlogits.t() @ h.float())
            else:
                dws[c0:c0 + chunk] = dlogits.t() @ h.float()
        dw = torch.cat(dws) if create_graph else dws
        return dh.to(h.dtype), dw.to(w.dtype), None, None


def chunked_lm_xent(h, w, labels, chunk=8192):
    """Per-row ``-log softmax(h @ w.T)[labels]`` over vocabulary chunks of
    ``chunk`` rows of ``w``: h (N, D), w (V, D), labels (N,) integer
    (out of range clipped). Returns fp32 losses (N,); gradients flow to h
    and w, to any order."""
    return _ChunkedLMXent.apply(h, w, labels, int(chunk))
