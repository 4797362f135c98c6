"""Transformer layers.

Counterpart of ``mxnet_tpu/gluon/nn/transformer.py``: ``MultiHeadAttention``,
``PositionwiseFFN`` (any ``npx.activation`` type, and gelu),
``TransformerEncoderCell``, ``TransformerEncoder`` and
``TransformerDecoderCell`` (causal self-attention, cross-attention, FFN,
post-norm), the first three with ``forward`` and the KV-cache surface (``init_cache`` for
floating-point dtypes and "int8", ``prefill``, ``decode_step``,
``prefill_suffix``, ``decode_multi``, ``copy_cache_rows``) in both norm
layouts,
``valid_length_mask`` and ``positional_encoding``. Attention without a mask or live dropout routes
to the flash-attention kernels (``ops/attention.py``). The post-norm
cell's ``forward`` routes ``LN(x + dropout(h))`` through the fused
ln_residual kernels where the ``fused_ln_residual`` knob says so
(:func:`_fused_ln_residual`); its KV-cache surface stays plain.
"""
from __future__ import annotations

import torch

from ... import amp, autograd, config
from ...numpy_extension import tensor_ops as npx
from ... import random as _random
from ...base import MXNetError
from ...context import resolve_device
from ...ops.ln_residual import ln_residual_dropout
from ..block import HybridBlock
from .basic_layers import Dense, Dropout, LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "TransformerEncoder", "TransformerDecoderCell", "valid_length_mask",
           "positional_encoding"]


class MultiHeadAttention(HybridBlock):
    """Multi-head self or cross attention on (batch, seq, units)."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 causal=False, device=None):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by "
                             f"num_heads {num_heads}")
        device = resolve_device(device)
        self._units = units
        self._heads = num_heads
        self._causal = causal
        self._dropout = dropout
        #: explicit generator for attention dropout, live while
        #: ``autograd.is_training()``
        self.generator = None
        proj = dict(use_bias=use_bias, flatten=False, in_units=units,
                    device=device)
        self.query_proj = Dense(units, **proj)
        self.key_proj = Dense(units, **proj)
        self.value_proj = Dense(units, **proj)
        self.out_proj = Dense(units, **proj)

    def forward(self, query, key=None, value=None, mask=None):
        from ...ops.attention import multi_head_attention
        key = query if key is None else key
        value = key if value is None else value
        q = self.query_proj(query)
        k = self.key_proj(key)
        v = self.value_proj(value)
        out = multi_head_attention(
            q, k, v, self._heads, mask=mask,
            dropout_p=self._dropout,
            causal=self._causal, generator=self.generator)
        return self.out_proj(out)

    # -- KV-cache serving surface --------------------------------------
    # Self-attention only: prefill writes a whole prompt into one cache
    # slot, decode_step advances every slot by one token. The caches are
    # updated in place and returned.

    def init_cache(self, max_slots, max_seq, dtype=torch.float32):
        """Preallocate one (k, v) cache pair:
        (max_slots, max_seq, heads, head_dim) each, on the block's device.

        ``dtype="int8"`` selects quantized storage: each of k/v becomes a
        (values int8, scales float32) pair with one symmetric scale per
        (slot, row, head), shaped (max_slots, max_seq, heads, 1)."""
        d = self._units // self._heads
        shape = (max_slots, max_seq, self._heads, d)
        dev = self.device
        if str(dtype) == "int8":
            sshape = (max_slots, max_seq, self._heads, 1)
            return tuple((torch.zeros(shape, dtype=torch.int8, device=dev),
                          torch.ones(sshape, dtype=torch.float32,
                                     device=dev)) for _ in range(2))
        dtype = _cache_dtype(dtype)
        return (torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev))

    @staticmethod
    def _cache_is_q8(kv):
        return isinstance(kv[0], (tuple, list))

    def _qkv(self, x):
        return self.query_proj(x), self.key_proj(x), self.value_proj(x)

    def prefill(self, x, kv, slot):
        """Full causal self-attention over one prompt (1, L, units),
        recording projected K/V into cache slot ``slot``."""
        from ...ops.attention import (multi_head_attention,
                                      write_prefill_kv, write_prefill_kv_q8)
        q, k, v = self._qkv(x)
        if self._cache_is_q8(kv):
            (kc, ks), (vc, vs) = kv
            kc, ks, vc, vs = write_prefill_kv_q8(kc, ks, vc, vs, k, v,
                                                 slot, self._heads)
            new_kv = ((kc, ks), (vc, vs))
        else:
            new_kv = write_prefill_kv(kv[0], kv[1], k, v, slot, self._heads)
        out = multi_head_attention(q, k, v, self._heads, causal=True)
        return self.out_proj(out), new_kv

    def _cached(self, plain, q8, x, kv, *args):
        """Run a cached-attention op (``plain`` on the fp cache, ``q8`` on
        the int8 layout) on x's projections; (out_proj(out), new kv)."""
        q, k, v = self._qkv(x)
        if self._cache_is_q8(kv):
            (kc, ks), (vc, vs) = kv
            out, kc, ks, vc, vs = q8(q, k, v, kc, ks, vc, vs, *args,
                                     self._heads)
            return self.out_proj(out), ((kc, ks), (vc, vs))
        out, k_cache, v_cache = plain(q, k, v, kv[0], kv[1], *args,
                                      self._heads)
        return self.out_proj(out), (k_cache, v_cache)

    def decode_step(self, x, kv, positions):
        """One cached decode step: x is (slots, 1, units), ``positions``
        (slots,) the cache row each slot's token occupies."""
        from ...ops.attention import decode_attention, decode_attention_q8
        return self._cached(decode_attention, decode_attention_q8, x, kv,
                            positions)

    def prefill_suffix(self, x, kv, slot, start):
        """Prefix-cache suffix prefill: x (1, Ls, units) is the prompt
        suffix; rows [0, start) of ``slot`` already hold a copied prefix
        the suffix attends to."""
        from ...ops.attention import (suffix_prefill_attention,
                                      suffix_prefill_attention_q8)
        return self._cached(suffix_prefill_attention,
                            suffix_prefill_attention_q8, x, kv, slot, start)

    def decode_multi(self, x, kv, positions):
        """t-token cached decode (the speculative-decoding verify): x is
        (slots, t, units), slot i's token j landing at cache row
        positions[i] + j with causal visibility."""
        from ...ops.attention import (decode_multi_attention,
                                      decode_multi_attention_q8)
        return self._cached(decode_multi_attention,
                            decode_multi_attention_q8, x, kv, positions)

    def copy_cache_rows(self, kv, src_slot, src_row, dst_slot, dst_row,
                        rows):
        """Copy ``rows`` KV rows between slots (the prefix-cache block
        copy), in place, on the fp and the int8 layouts alike."""
        from ...ops.attention import copy_cache_rows
        return copy_cache_rows(kv, src_slot, src_row, dst_slot, dst_row,
                               rows)


def _cache_dtype(dtype):
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise MXNetError(f"KV cache dtype must be floating point or "
                         f"'int8', got {dtype!r}")
    return dtype


class PositionwiseFFN(HybridBlock):
    """Transformer FFN block (dense -> act -> dense), gluon-nlp layout."""

    def __init__(self, units, hidden_size, activation="gelu", dropout=0.0,
                 use_bias=True, device=None):
        super().__init__()
        device = resolve_device(device)
        self._activation = activation
        self.ffn_1 = Dense(hidden_size, use_bias=use_bias, flatten=False,
                           in_units=units, device=device)
        self.ffn_2 = Dense(units, use_bias=use_bias, flatten=False,
                           in_units=hidden_size, device=device)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        h = self.ffn_1(x)
        h = npx.gelu(h) if self._activation == "gelu" \
            else npx.activation(h, act_type=self._activation)
        h = self.ffn_2(h)
        if self.dropout is not None:
            h = self.dropout(h)
        return h


def _fused_ln_residual(x, h, ln, p, generator=None):
    """``ln(x + dropout(h))`` through the fused ln_residual kernels when the
    ``fused_ln_residual`` knob routes it there, else None (the caller then
    runs the unfused composition). Reference: transformer.py:187-240.

    - "off" never fuses; "on" always does (on the CPU through the kernels'
      plain versions);
    - "auto" fuses a CUDA tensor while dropout is live
      (``autograd.is_training()`` and ``p > 0``): the reference's
      accelerator-and-live-dropout rule. Whether the card gains from fusing
      without dropout too is measured, not assumed (``PERF.md``).

    The dropout rate applies only while ``autograd.is_training()``. The
    mask is drawn by the very call ``Dropout`` makes
    (``random.dropout_mask``), on ``generator`` (the cell's dropout block's)
    or else the default generator of h's device, so fused and unfused draw
    the same mask. The reference's TPU lane rule (``D % 128``) is not
    carried over: the kernels take any D up to their maximum."""
    mode = config.get("fused_ln_residual")
    if mode not in ("auto", "on", "off"):
        raise MXNetError(f"fused_ln_residual must be 'auto', 'on' or 'off', "
                         f"got {mode!r}")
    training = autograd.is_training()
    if mode == "off" or (mode == "auto" and not (
            x.device.type == "cuda" and training and p > 0)):
        return None
    p_eff = float(p) if training else 0.0
    mask = _random.dropout_mask(h, p_eff, generator) if p_eff > 0 else None
    # the reference's dispatch name; in no AMP list, so the residual keeps
    # its dtypes (fp32 x and bf16 h under amp.init widen to fp32 there)
    x, h, gamma, beta = amp._maybe_cast_op_inputs(
        "fused_ln_residual", (x, h, ln.gamma, ln.beta))
    return ln_residual_dropout(x, h, gamma, beta, p=p_eff, mask=mask,
                               eps=ln._epsilon)


class TransformerEncoderCell(HybridBlock):
    """One encoder layer: MHA + FFN with residuals. pre_norm=False is the
    BERT/original layout, pre_norm=True the GPT layout."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 attention_dropout=0.0, activation="gelu", pre_norm=False,
                 causal=False, device=None):
        super().__init__()
        device = resolve_device(device)
        self._pre_norm = pre_norm
        self.attention = MultiHeadAttention(units, num_heads,
                                            dropout=attention_dropout,
                                            causal=causal, device=device)
        self.attn_ln = LayerNorm(in_channels=units, device=device)
        self.ffn = PositionwiseFFN(units, hidden_size, activation, dropout,
                                   device=device)
        self.ffn_ln = LayerNorm(in_channels=units, device=device)
        self.dropout = Dropout(dropout) if dropout else None
        self._rate = float(dropout)

    def _drop(self, h):
        return self.dropout(h) if self.dropout is not None else h

    def forward(self, x, mask=None):
        if self._pre_norm:
            h = self.attention(self.attn_ln(x), mask=mask)
            x = x + self._drop(h)
            return x + self.ffn(self.ffn_ln(x))
        h = self.attention(x, mask=mask)
        gen = self.dropout.generator if self.dropout is not None else None
        fused = _fused_ln_residual(x, h, self.attn_ln, self._rate, gen)
        x = fused if fused is not None else self.attn_ln(x + self._drop(h))
        # the FFN applies its own dropout: the residual adds it as it is
        h = self.ffn(x)
        fused = _fused_ln_residual(x, h, self.ffn_ln, 0.0)
        return fused if fused is not None else self.ffn_ln(x + h)

    # -- KV-cache serving surface (inference only: dropout skipped) -----

    def init_cache(self, max_slots, max_seq, dtype=torch.float32):
        return self.attention.init_cache(max_slots, max_seq, dtype)

    def _cached(self, method, x, kv, *args):
        """The cell around one cached-attention method of its attention
        block, in its norm layout."""
        attend = getattr(self.attention, method)
        if self._pre_norm:
            h, kv = attend(self.attn_ln(x), kv, *args)
            x = x + h
            return x + self.ffn(self.ffn_ln(x)), kv
        h, kv = attend(x, kv, *args)
        x = self.attn_ln(x + h)
        return self.ffn_ln(x + self.ffn(x)), kv

    def prefill(self, x, kv, slot):
        return self._cached("prefill", x, kv, slot)

    def decode_step(self, x, kv, positions):
        return self._cached("decode_step", x, kv, positions)

    def prefill_suffix(self, x, kv, slot, start):
        return self._cached("prefill_suffix", x, kv, slot, start)

    def decode_multi(self, x, kv, positions):
        return self._cached("decode_multi", x, kv, positions)

    def copy_cache_rows(self, kv, src_slot, src_row, dst_slot, dst_row,
                        rows):
        return self.attention.copy_cache_rows(
            kv, src_slot, src_row, dst_slot, dst_row, rows)


class TransformerEncoder(HybridBlock):
    """Stack of encoder cells, registered as ``layer{i}``."""

    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, attention_dropout=0.0, activation="gelu",
                 pre_norm=False, causal=False, device=None):
        super().__init__()
        device = resolve_device(device)
        self._num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer{i}", TransformerEncoderCell(
                units, hidden_size, num_heads, dropout, attention_dropout,
                activation, pre_norm, causal, device=device))

    @property
    def _layers(self):
        return [getattr(self, f"layer{i}") for i in range(self._num_layers)]

    def forward(self, x, mask=None):
        for cell in self._layers:
            x = cell(x, mask=mask)
        return x

    # -- KV-cache serving surface --------------------------------------

    def init_cache(self, max_slots, max_seq, dtype=torch.float32):
        """One (k, v) pair per layer: the whole decode footprint,
        allocated once and updated in place by the serve engine."""
        return [cell.init_cache(max_slots, max_seq, dtype)
                for cell in self._layers]

    def _cached(self, method, x, caches, *args):
        out = []
        for cell, kv in zip(self._layers, caches):
            x, kv = getattr(cell, method)(x, kv, *args)
            out.append(kv)
        return x, out

    def prefill(self, x, caches, slot):
        return self._cached("prefill", x, caches, slot)

    def decode_step(self, x, caches, positions):
        return self._cached("decode_step", x, caches, positions)

    def prefill_suffix(self, x, caches, slot, start):
        return self._cached("prefill_suffix", x, caches, slot, start)

    def decode_multi(self, x, caches, positions):
        return self._cached("decode_multi", x, caches, positions)

    def copy_cache_rows(self, caches, src_slot, src_row, dst_slot,
                        dst_row, rows):
        return [cell.copy_cache_rows(kv, src_slot, src_row, dst_slot,
                                     dst_row, rows)
                for cell, kv in zip(self._layers, caches)]


class TransformerDecoderCell(HybridBlock):
    """One decoder layer, post-norm (reference: transformer.py
    ``TransformerDecoderCell``): causal self-attention, cross-attention on
    ``mem`` (``mem_mask``), FFN, each with its residual and LayerNorm."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 attention_dropout=0.0, activation="relu", device=None):
        super().__init__()
        device = resolve_device(device)
        self.self_attention = MultiHeadAttention(
            units, num_heads, dropout=attention_dropout, causal=True,
            device=device)
        self.self_ln = LayerNorm(in_channels=units, device=device)
        self.cross_attention = MultiHeadAttention(
            units, num_heads, dropout=attention_dropout, device=device)
        self.cross_ln = LayerNorm(in_channels=units, device=device)
        self.ffn = PositionwiseFFN(units, hidden_size, activation, dropout,
                                   device=device)
        self.ffn_ln = LayerNorm(in_channels=units, device=device)
        self.dropout = Dropout(dropout) if dropout else None

    def _drop(self, h):
        return self.dropout(h) if self.dropout is not None else h

    def forward(self, x, mem, mem_mask=None):
        x = self.self_ln(x + self._drop(self.self_attention(x)))
        h = self.cross_attention(x, mem, mem, mask=mem_mask)
        x = self.cross_ln(x + self._drop(h))
        return self.ffn_ln(x + self.ffn(x))


def positional_encoding(seq_len, units, dtype="float32", device=None):
    """The sinusoidal position table (seq_len, units) as an ``mx.np``
    array on ``device`` (the current context by default) (reference:
    transformer.py ``positional_encoding``)."""
    import numpy as onp
    from ... import numpy as mxnp
    pos = onp.arange(seq_len)[:, None]
    dim = onp.arange((units + 1) // 2)[None]
    angle = pos / onp.power(10000.0, 2 * dim / units)
    table = onp.zeros((seq_len, units), dtype=dtype)
    table[:, 0::2] = onp.sin(angle)
    table[:, 1::2] = onp.cos(angle[:, : units // 2])
    return mxnp.array(table, device=device)


def valid_length_mask(valid_length, seq_len):
    """(batch,) valid lengths -> (batch, 1, 1, seq) bool attention mask:
    key ``j`` is visible where ``j < valid_length`` (reference:
    transformer.py:426-430)."""
    ar = torch.arange(seq_len, device=valid_length.device).reshape(
        1, 1, 1, seq_len)
    return ar < valid_length.reshape(-1, 1, 1, 1)
