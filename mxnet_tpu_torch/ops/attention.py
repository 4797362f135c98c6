"""Attention dispatch and the KV-cache attention ops of the serving path.

Counterpart of ``mxnet_tpu/ops/attention.py``: ``_reference_attention``,
``multi_head_attention`` and the KV-cache ops of the serve engine:
``write_prefill_kv`` and ``decode_attention``, their int8-cache variants
(``write_prefill_kv_q8``, ``decode_attention_q8``; ``_quantize_kv_rows``),
the prefix cache's ``copy_cache_rows``, ``gather_cache_rows`` and
``suffix_prefill_attention(_q8)``, and speculative decoding's
``decode_multi_attention(_q8)``. These stay plain compositions, as in the
reference (einsums, no Pallas kernel).

Routing of :func:`multi_head_attention`: with no mask and no live dropout
it goes to :func:`..flash_attention.attention` wherever the kernels have an
instantiation for the shape and dtype (:func:`_flash_instantiated`:
float32 or bfloat16, and on the card a head_dim of
``flash_attention.HEAD_DIMS``), which launches the forward CUDA kernel for
a CUDA tensor (and the two backward kernels when autograd differentiates
it) and takes the kernels' plain versions for a CPU tensor; any other
shape or dtype takes the plain composition, decided before any launch. Dropout is live only while ``autograd.is_training()``, as in
the reference. The JAX package's TPU thresholds (flash only from
seq 512 causal / 2048 otherwise) are not carried over; the H100 threshold
is still to be measured. A mask or live dropout takes the plain
composition, as in the reference; attention dropout draws from the
caller's generator, else from the default generator of the tensor's
device (``random.dropout_mask``). A kernel failure raises: the
reference's silent fallback to the composition is deliberately absent.

The JAX package returns new cache arrays from pure functions; here the
preallocated caches are updated in place (``index_put_`` /
``index_copy_``) and returned for the same call shape. Slot, start and row
operands may be device tensors (no host read): the serve engine captures
these ops in CUDA graphs that serve every slot.

:func:`multi_head_attention` takes the AMP policy under its reference
dispatch name, "multi_head_attention" (``amp._maybe_cast_op_inputs``).
"""
from __future__ import annotations

import torch

from .. import amp, autograd
from ..random import dropout_mask
from .flash_attention import _DTYPE_CODES, HEAD_DIMS, attention

__all__ = ["multi_head_attention", "write_prefill_kv", "decode_attention",
           "write_prefill_kv_q8", "decode_attention_q8", "copy_cache_rows",
           "gather_cache_rows", "suffix_prefill_attention",
           "suffix_prefill_attention_q8", "decode_multi_attention",
           "decode_multi_attention_q8"]

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
    neg = max(_NEG_INF, torch.finfo(scores.dtype).min)  # fp16's is -65504
    if causal:
        cm = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(cm, scores, neg)
    if mask is not None:
        scores = torch.where(mask.to(torch.bool), scores, neg)
    att = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if dropout_p:
        att = att * dropout_mask(att, dropout_p, generator) \
            / (1.0 - dropout_p)
    out = torch.einsum("bhqk,bhkd->bhqd", att, vh)
    return out.transpose(1, 2).reshape(b, sq, heads * d)


def _flash_instantiated(query, heads):
    """Whether the flash route takes ``query``'s dtype and, on the card,
    its head_dim (the CUDA kernels' instantiations)."""
    if query.dtype not in _DTYPE_CODES:
        return False
    return query.device.type == "cpu" \
        or query.shape[-1] // heads in HEAD_DIMS


def multi_head_attention(query, key, value, heads, mask=None, dropout_p=0.0,
                         causal=False, generator=None):
    """Fused MHA on (batch, seq, heads*dim) tensors, differentiable in
    query, key and value. ``dropout_p`` applies only while
    ``autograd.is_training()`` (reference: ops/attention.py:412-414)."""
    if not autograd.is_training():
        dropout_p = 0.0
    query, key, value = amp._maybe_cast_op_inputs(
        "multi_head_attention", (query, key, value))
    if mask is not None or dropout_p \
            or not _flash_instantiated(query, heads):
        return _reference_attention(query, key, value, heads, mask, causal,
                                    None, dropout_p, generator)
    b, sq, hd = query.shape
    out = attention(_heads_first(query, heads), _heads_first(key, heads),
                    _heads_first(value, heads), causal=causal)
    return out.reshape(b, heads, sq, hd // heads).transpose(1, 2) \
        .reshape(b, sq, hd)


def _scalar(v, device):
    """A 0-d int64 tensor on ``device`` of a slot, row or start operand
    (a Python int or a tensor): inside a captured CUDA graph these arrive
    as device tensors, so that one graph serves every value."""
    return torch.as_tensor(v, device=device).long().reshape(())


def _slice_rows(cache, slot, start, rows):
    """(slot index, row index) tensors of ``rows`` consecutive cache rows
    from ``start`` in ``slot``, both clamped as ``dynamic_update_slice``
    clamps its start (slot to [0, slots), start to [0, max_seq - rows])."""
    n, max_seq = cache.shape[:2]
    dev = cache.device
    s = _scalar(slot, dev).clamp(0, n - 1)
    r = torch.arange(rows, device=dev)
    if isinstance(start, int):  # no host-to-device copy inside a capture
        return s.expand(rows), r + min(max(start, 0), max_seq - rows)
    return s.expand(rows), r + _scalar(start, dev).clamp(0, max_seq - rows)


def write_prefill_kv(k_cache, v_cache, key, value, slot, heads):
    """Write a whole prompt's projected K/V into one cache slot, in place.

    ``key``/``value`` are (1, L, heads*dim); the caches are
    (max_slots, max_seq, heads, dim). Rows [slot, :L] are overwritten
    (rows beyond L keep stale values; they are never attended, because the
    decode mask is bounded by the slot's position counter and every row
    below it is rewritten in order before it becomes visible). ``slot``
    may be a device tensor, so one captured prefill serves every slot."""
    _, seq_len, hd = key.shape
    d = hd // heads
    idx = _slice_rows(k_cache, slot, 0, seq_len)
    k_cache.index_put_(idx, key.reshape(seq_len, heads, d)
                       .to(k_cache.dtype))
    v_cache.index_put_(idx, value.reshape(seq_len, heads, d)
                       .to(v_cache.dtype))
    return k_cache, v_cache


def _quantize_kv_rows(x, int8_max=127.0):
    """Symmetric int8 over the last (head_dim) axis: one scale per
    (slot, row, head); each written row computes its own scale, so the
    fixed-footprint cache never needs requantization. Divides by the scale
    (no reciprocal multiply) and rounds half to even, as the reference."""
    xf = x.float()
    # a true division by a device tensor (a filled one: no host copy inside
    # a capture); torch divides by a host scalar as a reciprocal multiply
    top = torch.full((), int8_max, device=xf.device)
    scale = xf.abs().amax(dim=-1, keepdim=True) / top
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xf / scale), -int8_max, int8_max)
    return q.to(torch.int8), scale


def write_prefill_kv_q8(k_cache, k_scale, v_cache, v_scale, key, value,
                        slot, heads):
    """int8-cache variant of :func:`write_prefill_kv`: quantizes the
    prompt's projected K/V per (row, head) and writes values and scales in
    place. Caches are (max_slots, max_seq, heads, dim) int8; scales
    (max_slots, max_seq, heads, 1) float32."""
    _, seq_len, hd = key.shape
    d = hd // heads
    kq, ksc = _quantize_kv_rows(key.reshape(seq_len, heads, d))
    vq, vsc = _quantize_kv_rows(value.reshape(seq_len, heads, d))
    idx = _slice_rows(k_cache, slot, 0, seq_len)
    k_cache.index_put_(idx, kq)
    k_scale.index_put_(idx, ksc)
    v_cache.index_put_(idx, vq)
    v_scale.index_put_(idx, vsc)
    return k_cache, k_scale, v_cache, v_scale


def _leaves(tree):
    """The tensors of a tree of tuples, lists and dicts, in order: a cache
    tree's (max_slots, max_seq, ...) leaves, the fp (k, v) pairs and the
    int8 ((values, scales), ...) layout alike."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    return [leaf for sub in tree for leaf in _leaves(sub)]


def copy_cache_rows(cache, src_slot, src_row, dst_slot, dst_row, rows):
    """Copy ``rows`` cache rows (one prefix-cache block) between slots, in
    place, in every leaf of ``cache`` (the per-(slot, row, head) scales of
    the int8 layout share the leading two axes and copy with their rows).
    Slot and row operands may be device tensors, so one captured graph
    serves every (src, dst) pair; ``rows`` is static. Returns ``cache``."""
    for leaf in _leaves(cache):
        blk = leaf[_slice_rows(leaf, src_slot, src_row, rows)]
        leaf.index_put_(_slice_rows(leaf, dst_slot, dst_row, rows), blk)
    return cache


def gather_cache_rows(cache, src_slots, src_rows, dst_slot):
    """Rebuild one destination slot from per-row source coordinates, in
    place: row ``r`` of ``dst_slot`` becomes row ``src_rows[r]`` of slot
    ``src_slots[r]`` in every leaf of ``cache`` (as
    :func:`copy_cache_rows`). One gather and one slot-sized write a leaf;
    the gather copies before the write, so a donor that is also the
    destination reads its rows as they were. Rows the caller wants
    untouched are identity coordinates (``dst_slot``, own row). All
    operands may be device tensors. Returns ``cache``."""
    for leaf in _leaves(cache):
        dev = leaf.device
        rows = leaf[torch.as_tensor(src_slots, device=dev).long(),
                    torch.as_tensor(src_rows, device=dev).long()]
        dst = _scalar(dst_slot, dev).clamp(0, leaf.shape[0] - 1)
        leaf.index_copy_(0, dst.reshape(1), rows[None])
    return cache


def _suffix_attend(q, kslot, vslot, start, heads):
    """Attention of a suffix's queries (1, Ls, heads*dim) over one slot's
    rows (max_seq, heads, dim): query i sees rows <= start + i."""
    _, ls, hd = q.shape
    d = hd // heads
    max_seq = kslot.shape[0]
    qh = q.reshape(ls, heads, d)
    scale = 1.0 / (d ** 0.5)
    scores = torch.einsum("qhd,shd->hqs", qh, kslot) * scale
    visible = (torch.arange(max_seq, device=q.device)[None, :]
               <= (start + torch.arange(ls, device=q.device))[:, None])
    scores = torch.where(visible[None, :, :], scores, _NEG_INF)
    att = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("hqs,shd->qhd", att, vslot)
    return out.reshape(1, ls, hd)


def suffix_prefill_attention(q, k, v, k_cache, v_cache, slot, start, heads):
    """Prefix-cache suffix prefill: causal attention of a prompt suffix
    (1, Ls, heads*dim) over cache slot ``slot`` whose rows [0, start)
    already hold a copied prefix. Writes the suffix K/V at rows
    [start, start + Ls) in place and lets query i attend every row
    <= start + i. ``slot`` and ``start`` may be device tensors; the caller
    keeps start + Ls <= max_seq (the engine takes the full prefill
    otherwise). Returns (out, k_cache, v_cache)."""
    _, ls, hd = q.shape
    d = hd // heads
    dev = q.device
    idx = _slice_rows(k_cache, slot, start, ls)
    k_cache.index_put_(idx, k.reshape(ls, heads, d).to(k_cache.dtype))
    v_cache.index_put_(idx, v.reshape(ls, heads, d).to(v_cache.dtype))
    s = idx[0][:1]
    kslot = k_cache.index_select(0, s)[0].to(q.dtype)
    vslot = v_cache.index_select(0, s)[0].to(q.dtype)
    out = _suffix_attend(q, kslot, vslot, _scalar(start, dev), heads)
    return out, k_cache, v_cache


def suffix_prefill_attention_q8(q, k, v, k_cache, k_scale, v_cache,
                                v_scale, slot, start, heads):
    """int8-cache variant of :func:`suffix_prefill_attention`: the suffix
    rows quantize with their own per-(row, head) scales before the write
    (beside the copied prefix's scales), and the slot's cached K/V
    dequantizes into the score and value products."""
    _, ls, hd = q.shape
    d = hd // heads
    dev = q.device
    kq, ksc = _quantize_kv_rows(k.reshape(ls, heads, d))
    vq, vsc = _quantize_kv_rows(v.reshape(ls, heads, d))
    idx = _slice_rows(k_cache, slot, start, ls)
    k_cache.index_put_(idx, kq)
    k_scale.index_put_(idx, ksc)
    v_cache.index_put_(idx, vq)
    v_scale.index_put_(idx, vsc)
    s = idx[0][:1]

    def slot_rows(c, sc):
        return (c.index_select(0, s)[0].to(q.dtype)
                * sc.index_select(0, s)[0].to(q.dtype))
    out = _suffix_attend(q, slot_rows(k_cache, k_scale),
                         slot_rows(v_cache, v_scale), _scalar(start, dev),
                         heads)
    return out, k_cache, k_scale, v_cache, v_scale


def _multi_rows(positions, t, max_seq):
    """(lane, rows, limit) of a t-token write per slot: slot i's token j
    lands at row positions[i] + j, clipped at max_seq - 1 (clipped writes
    only touch rows above the slot's position counter, rewritten before
    they become visible), and query j sees rows <= positions[i] + j."""
    pos = positions.long()
    limit = pos[:, None] + torch.arange(t, device=pos.device)
    lane = torch.arange(pos.shape[0], device=pos.device)[:, None]
    return lane.expand(-1, t), limit.clamp(0, max_seq - 1), limit


def _multi_attend(q, kf, vf, limit, heads):
    """(slots, t, heads*dim) queries over whole caches (slots, max_seq,
    heads, dim): query j of slot i sees rows <= limit[i, j]."""
    n, t, hd = q.shape
    d = hd // heads
    max_seq = kf.shape[1]
    qh = q.reshape(n, t, heads, d)
    scale = 1.0 / (d ** 0.5)
    scores = torch.einsum("nqhd,nshd->nhqs", qh, kf) * scale
    visible = (torch.arange(max_seq, device=q.device)[None, None, :]
               <= limit[:, :, None])[:, None, :, :]
    scores = torch.where(visible, scores, _NEG_INF)
    att = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("nhqs,nshd->nqhd", att, vf)
    return out.reshape(n, t, hd)


def decode_multi_attention(query, key, value, k_cache, v_cache, positions,
                           heads):
    """t-token cached attention, the speculative-decoding verify:
    ``query``/``key``/``value`` are (slots, t, heads*dim); slot i's token j
    is written in place at row positions[i] + j (clipped at max_seq - 1:
    one write may then land on a row twice, and which value stays is
    unspecified; no visible row is affected) and attends rows
    <= positions[i] + j. Returns (out, k_cache, v_cache)."""
    n, t, hd = query.shape
    d = hd // heads
    lane, rows, limit = _multi_rows(positions, t, k_cache.shape[1])
    k_cache.index_put_((lane, rows), key.reshape(n, t, heads, d)
                       .to(k_cache.dtype))
    v_cache.index_put_((lane, rows), value.reshape(n, t, heads, d)
                       .to(v_cache.dtype))
    out = _multi_attend(query, k_cache.to(query.dtype),
                        v_cache.to(query.dtype), limit, heads)
    return out, k_cache, v_cache


def decode_multi_attention_q8(query, key, value, k_cache, k_scale, v_cache,
                              v_scale, positions, heads):
    """int8-cache variant of :func:`decode_multi_attention`: each of the t
    written rows quantizes with its own (slot, row, head) scale, and the
    caches dequantize into the products as in
    :func:`decode_attention_q8`."""
    n, t, hd = query.shape
    d = hd // heads
    lane, rows, limit = _multi_rows(positions, t, k_cache.shape[1])
    kq, ksc = _quantize_kv_rows(key.reshape(n, t, heads, d))
    vq, vsc = _quantize_kv_rows(value.reshape(n, t, heads, d))
    k_cache.index_put_((lane, rows), kq)
    k_scale.index_put_((lane, rows), ksc)
    v_cache.index_put_((lane, rows), vq)
    v_scale.index_put_((lane, rows), vsc)
    dt = query.dtype
    out = _multi_attend(query, k_cache.to(dt) * k_scale.to(dt),
                        v_cache.to(dt) * v_scale.to(dt), limit, heads)
    return out, k_cache, k_scale, v_cache, v_scale


def decode_attention_q8(query, key, value, k_cache, k_scale, v_cache,
                        v_scale, positions, heads):
    """int8-cache variant of :func:`decode_attention`: the cache holds
    int8 values and per-(slot, row, head) fp32 scales and dequantizes
    (``to(dtype) * scale``) into the score and value products. The current
    token's K/V is quantized with its own row scale before the in-place
    write; the attention itself stays in the query's dtype with an fp32
    softmax, as the floating-point path."""
    n, _, hd = query.shape
    d = hd // heads
    max_seq = k_cache.shape[1]
    row = positions.long().clamp(0, max_seq - 1)
    lane = torch.arange(n, device=query.device)
    kq, ksc = _quantize_kv_rows(key.reshape(n, heads, d))
    vq, vsc = _quantize_kv_rows(value.reshape(n, heads, d))
    k_cache.index_put_((lane, row), kq)
    k_scale.index_put_((lane, row), ksc)
    v_cache.index_put_((lane, row), vq)
    v_scale.index_put_((lane, row), vsc)
    dt = query.dtype
    out = _multi_attend(query, k_cache.to(dt) * k_scale.to(dt),
                        v_cache.to(dt) * v_scale.to(dt), row[:, None],
                        heads)
    return out, k_cache, k_scale, v_cache, v_scale


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
