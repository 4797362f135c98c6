"""Attention dispatch and the KV-cache attention ops of the serving path.

Counterpart of ``mxnet_tpu/ops/attention.py``: ``_reference_attention``,
``multi_head_attention``, ``write_prefill_kv`` and ``decode_attention``
(floating-point cache only).

Routing of :func:`multi_head_attention`: with no mask and no live dropout
it always goes to :func:`..flash_attention.attention`, which launches the
forward CUDA kernel for a CUDA tensor (and the two backward kernels when
autograd differentiates it) and takes the kernels' plain versions for a
CPU tensor. Dropout is live only while ``autograd.is_training()``, as in
the reference. The JAX package's TPU thresholds (flash only from
seq 512 causal / 2048 otherwise) are not carried over; the H100 threshold
is still to be measured. A mask or live dropout takes the plain
composition, as in the reference; attention dropout draws from the
caller's generator, else from the default generator of the tensor's
device (``random.dropout_mask``). A kernel failure raises: the
reference's silent fallback to the composition is deliberately absent.

The JAX package returns new cache arrays from pure functions; here the
preallocated caches are updated in place (slice assignment /
``index_put_``) and returned for the same call shape.
"""
from __future__ import annotations

import torch

from .. import autograd
from ..random import dropout_mask
from .flash_attention import attention

__all__ = ["multi_head_attention", "write_prefill_kv", "decode_attention"]

_NEG_INF = -1e30


def _heads_first(x, heads):
    """(b, s, heads*d) -> contiguous (b*heads, s, d)."""
    b, s, hd = x.shape
    d = hd // heads
    return x.reshape(b, s, heads, d).transpose(1, 2).reshape(
        b * heads, s, d).contiguous()


def _reference_attention(q, k, v, heads, mask=None, causal=False, scale=None,
                         dropout_p=0.0, generator=None):
    """(batch, seq, heads*dim) plain composition."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // heads
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qh = q.reshape(b, sq, heads, d).transpose(1, 2)
    kh = k.reshape(b, sk, heads, d).transpose(1, 2)
    vh = v.reshape(b, sk, heads, d).transpose(1, 2)
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    if causal:
        cm = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(cm, scores, _NEG_INF)
    if mask is not None:
        scores = torch.where(mask.to(torch.bool), scores, _NEG_INF)
    att = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if dropout_p:
        att = att * dropout_mask(att, dropout_p, generator) \
            / (1.0 - dropout_p)
    out = torch.einsum("bhqk,bhkd->bhqd", att, vh)
    return out.transpose(1, 2).reshape(b, sq, heads * d)


def multi_head_attention(query, key, value, heads, mask=None, dropout_p=0.0,
                         causal=False, generator=None):
    """Fused MHA on (batch, seq, heads*dim) tensors, differentiable in
    query, key and value. ``dropout_p`` applies only while
    ``autograd.is_training()`` (reference: ops/attention.py:412-414)."""
    if not autograd.is_training():
        dropout_p = 0.0
    if mask is not None or dropout_p:
        return _reference_attention(query, key, value, heads, mask, causal,
                                    None, dropout_p, generator)
    b, sq, hd = query.shape
    out = attention(_heads_first(query, heads), _heads_first(key, heads),
                    _heads_first(value, heads), causal=causal)
    return out.reshape(b, heads, sq, hd // heads).transpose(1, 2) \
        .reshape(b, sq, hd)


def write_prefill_kv(k_cache, v_cache, key, value, slot, heads):
    """Write a whole prompt's projected K/V into one cache slot, in place.

    ``key``/``value`` are (1, L, heads*dim); the caches are
    (max_slots, max_seq, heads, dim). Rows [slot, :L] are overwritten
    (rows beyond L keep stale values; they are never attended, because the
    decode mask is bounded by the slot's position counter and every row
    below it is rewritten in order before it becomes visible)."""
    _, seq_len, hd = key.shape
    d = hd // heads
    k_cache[slot, :seq_len] = key.reshape(seq_len, heads, d)
    v_cache[slot, :seq_len] = value.reshape(seq_len, heads, d)
    return k_cache, v_cache


def decode_attention(query, key, value, k_cache, v_cache, positions, heads):
    """Single-token cached attention for continuous-batching decode.

    ``query``/``key``/``value`` are (slots, 1, heads*dim) projections of the
    current token in every slot; caches are (slots, max_seq, heads, dim);
    ``positions`` (slots,) is the row each slot's new K/V lands in (clipped
    at ``max_seq - 1``). Writes the new K/V in place (``index_put_``),
    attends rows <= positions, and returns (out, k_cache, v_cache). Scores
    are (slots, heads, max_seq): small, so no flash path."""
    n, _, hd = query.shape
    d = hd // heads
    max_seq = k_cache.shape[1]
    row = positions.long().clamp(0, max_seq - 1)
    lane = torch.arange(n, device=query.device)
    k_cache.index_put_((lane, row), key.reshape(n, heads, d)
                       .to(k_cache.dtype))
    v_cache.index_put_((lane, row), value.reshape(n, heads, d)
                       .to(v_cache.dtype))
    qh = query.reshape(n, heads, d)
    scale = 1.0 / (d ** 0.5)
    scores = torch.einsum("nhd,nshd->nhs", qh,
                          k_cache.to(query.dtype)) * scale
    visible = (torch.arange(max_seq, device=query.device)[None, :]
               <= row[:, None])[:, None, :]
    scores = torch.where(visible, scores, _NEG_INF)
    att = torch.softmax(scores.float(), dim=-1).to(query.dtype)
    out = torch.einsum("nhs,nshd->nhd", att, v_cache.to(query.dtype))
    return out.reshape(n, 1, hd), k_cache, v_cache
