"""Transformer layers.

Counterpart of ``mxnet_tpu/gluon/nn/transformer.py``: ``MultiHeadAttention``,
``PositionwiseFFN``, ``TransformerEncoderCell`` and ``TransformerEncoder``,
each with ``forward`` and the KV-cache surface (``init_cache`` for
floating-point dtypes, ``prefill``, ``decode_step``) in both norm layouts,
and ``valid_length_mask``. Attention without a mask or live dropout routes
to the flash-attention kernels (``ops/attention.py``). The post-norm
cell's ``forward`` routes ``LN(x + dropout(h))`` through the fused
ln_residual kernels where the ``fused_ln_residual`` knob says so
(:func:`_fused_ln_residual`); its KV-cache surface stays plain.
"""
from __future__ import annotations

import torch

from ... import autograd, config
from ... import numpy_extension as npx
from ... import random as _random
from ...base import MXNetError
from ...context import resolve_device
from ...ops.ln_residual import ln_residual_dropout
from ..block import HybridBlock
from .basic_layers import Dense, Dropout, LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "TransformerEncoder", "valid_length_mask"]


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
        (max_slots, max_seq, heads, head_dim) each, on the block's device."""
        dtype = _cache_dtype(dtype)
        d = self._units // self._heads
        shape = (max_slots, max_seq, self._heads, d)
        dev = self.device
        return (torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev))

    def prefill(self, x, kv, slot):
        """Full causal self-attention over one prompt (1, L, units),
        recording projected K/V into cache slot ``slot``."""
        from ...ops.attention import multi_head_attention, write_prefill_kv
        q = self.query_proj(x)
        k = self.key_proj(x)
        v = self.value_proj(x)
        new_kv = write_prefill_kv(kv[0], kv[1], k, v, slot, self._heads)
        out = multi_head_attention(q, k, v, self._heads, causal=True)
        return self.out_proj(out), new_kv

    def decode_step(self, x, kv, positions):
        """One cached decode step: x is (slots, 1, units), ``positions``
        (slots,) the cache row each slot's token occupies."""
        from ...ops.attention import decode_attention
        q = self.query_proj(x)
        k = self.key_proj(x)
        v = self.value_proj(x)
        out, k_cache, v_cache = decode_attention(
            q, k, v, kv[0], kv[1], positions, self._heads)
        return self.out_proj(out), (k_cache, v_cache)


def _cache_dtype(dtype):
    if isinstance(dtype, str):
        if dtype == "int8":
            raise MXNetError("int8 KV cache is not part of this slice of "
                             "the port")
        dtype = getattr(torch, dtype, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise MXNetError(f"KV cache dtype must be floating point, got "
                         f"{dtype!r}")
    return dtype


class PositionwiseFFN(HybridBlock):
    """Transformer FFN block (dense -> act -> dense), gluon-nlp layout."""

    def __init__(self, units, hidden_size, activation="gelu", dropout=0.0,
                 use_bias=True, device=None):
        super().__init__()
        if activation != "gelu":
            raise MXNetError(f"activation {activation!r} is not part of "
                             "this slice of the port (gelu only)")
        device = resolve_device(device)
        self.ffn_1 = Dense(hidden_size, use_bias=use_bias, flatten=False,
                           in_units=units, device=device)
        self.ffn_2 = Dense(units, use_bias=use_bias, flatten=False,
                           in_units=hidden_size, device=device)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        h = self.ffn_2(npx.gelu(self.ffn_1(x)))
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
    return ln_residual_dropout(x, h, ln.gamma, ln.beta, p=p_eff, mask=mask,
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

    def prefill(self, x, kv, slot):
        if self._pre_norm:
            h, kv = self.attention.prefill(self.attn_ln(x), kv, slot)
            x = x + h
            return x + self.ffn(self.ffn_ln(x)), kv
        h, kv = self.attention.prefill(x, kv, slot)
        x = self.attn_ln(x + h)
        return self.ffn_ln(x + self.ffn(x)), kv

    def decode_step(self, x, kv, positions):
        if self._pre_norm:
            h, kv = self.attention.decode_step(self.attn_ln(x), kv,
                                               positions)
            x = x + h
            return x + self.ffn(self.ffn_ln(x)), kv
        h, kv = self.attention.decode_step(x, kv, positions)
        x = self.attn_ln(x + h)
        return self.ffn_ln(x + self.ffn(x)), kv


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

    def prefill(self, x, caches, slot):
        out = []
        for cell, kv in zip(self._layers, caches):
            x, kv = cell.prefill(x, kv, slot)
            out.append(kv)
        return x, out

    def decode_step(self, x, caches, positions):
        out = []
        for cell, kv in zip(self._layers, caches):
            x, kv = cell.decode_step(x, kv, positions)
            out.append(kv)
        return x, out


def valid_length_mask(valid_length, seq_len):
    """(batch,) valid lengths -> (batch, 1, 1, seq) bool attention mask:
    key ``j`` is visible where ``j < valid_length`` (reference:
    transformer.py:426-430)."""
    ar = torch.arange(seq_len, device=valid_length.device).reshape(
        1, 1, 1, seq_len)
    return ar < valid_length.reshape(-1, 1, 1, 1)
