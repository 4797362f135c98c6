"""Decoder-only LLM family (GPT-2 layout).

Counterpart of ``mxnet_tpu/gluon/model_zoo/gpt.py``: pre-norm causal
blocks whose prefill attention runs through the flash-attention CUDA
kernel, learned positions, and an LM head tied to the word embedding (one
parameter, ``backbone.word_embed.weight``). Each constructor takes a
``device``: ``None`` means ``cuda:0`` and raises without CUDA.
"""
from __future__ import annotations

import torch

from ... import amp
from ...context import resolve_device
from ..block import HybridBlock, recording_gate
from ..nn import Dropout, Embedding, LayerNorm
from ..nn.transformer import TransformerEncoder

__all__ = ["GPTModel", "GPTForCausalLM", "gpt2_124m", "gpt2_355m"]


class GPTModel(HybridBlock):
    """Causal pre-norm transformer decoder stack (GPT-2 layout).

    forward(inputs (b, s) int) -> hidden states (b, s, units)
    """

    def __init__(self, vocab_size=50257, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=1024,
                 dropout=0.1, embed_dropout=0.1, device=None):
        super().__init__()
        device = resolve_device(device)
        self._units = units
        self._max_length = max_length
        self.word_embed = Embedding(vocab_size, units, device=device)
        self.position_embed = Embedding(max_length, units, device=device)
        self.embed_dropout = Dropout(embed_dropout) if embed_dropout else None
        self.decoder = TransformerEncoder(
            num_layers, units, hidden_size, num_heads, dropout=dropout,
            attention_dropout=dropout, activation="gelu", pre_norm=True,
            causal=True, device=device)
        self.final_ln = LayerNorm(epsilon=1e-5, in_channels=units,
                                  device=device)

    def _embed(self, inputs, pos):
        return self.word_embed(inputs) + self.position_embed(pos)

    def forward(self, inputs):
        _, s = inputs.shape
        pos = torch.arange(s, device=inputs.device).reshape(1, s)
        x = self._embed(inputs, pos)
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        return self.final_ln(self.decoder(x))

    # -- KV-cache serving surface (mx.serve) ---------------------------

    @property
    def max_length(self):
        return self._max_length

    def init_cache(self, max_slots, max_seq=None, dtype=torch.float32):
        """Fixed-footprint decode cache: per layer one
        (max_slots, max_seq, heads, head_dim) K and V pair (``"int8"``:
        each a (values, scales) pair)."""
        max_seq = self._max_length if max_seq is None else max_seq
        if max_seq > self._max_length:
            raise ValueError(
                f"max_seq {max_seq} exceeds the learned position table "
                f"({self._max_length})")
        return self.decoder.init_cache(max_slots, max_seq, dtype)

    def prefill(self, inputs, caches, slot):
        """Run one prompt (1, L) through the stack, writing K/V into
        cache slot ``slot``. Returns (hidden (1, L, units), caches)."""
        _, s = inputs.shape
        pos = torch.arange(s, device=inputs.device).reshape(1, s)
        x, caches = self.decoder.prefill(self._embed(inputs, pos), caches,
                                         slot)
        return self.final_ln(x), caches

    def decode_step(self, tokens, caches, positions):
        """Advance every slot one token: tokens (slots, 1) int,
        positions (slots,) int cache rows. Returns
        (hidden (slots, 1, units), caches)."""
        x = self._embed(tokens, positions.reshape(-1, 1))
        x, caches = self.decoder.decode_step(x, caches, positions)
        return self.final_ln(x), caches

    def prefill_suffix(self, inputs, caches, slot, start):
        """Prefix-cache suffix prefill: ``inputs`` (1, Ls) is the prompt
        suffix; rows [0, start) of cache slot ``slot`` already hold a
        copied prefix, so positions offset by ``start`` (clamped at
        max_length - 1) and the suffix attends the cached rows. Returns
        (hidden (1, Ls, units), caches)."""
        _, s = inputs.shape
        start = torch.as_tensor(start, device=inputs.device)
        pos = (torch.arange(s, device=inputs.device).reshape(1, s) + start
               ).clamp(max=self._max_length - 1)
        x, caches = self.decoder.prefill_suffix(self._embed(inputs, pos),
                                                caches, slot, start)
        return self.final_ln(x), caches

    def decode_multi(self, tokens, caches, positions):
        """Advance every slot t tokens at once (the speculative-decoding
        verify): tokens (slots, t) int, slot i's token j landing at cache
        row positions[i] + j. Returns (hidden (slots, t, units), caches)."""
        _, t = tokens.shape
        pos = (torch.arange(t, device=tokens.device).reshape(1, t)
               + positions.reshape(-1, 1)).clamp(max=self._max_length - 1)
        x, caches = self.decoder.decode_multi(self._embed(tokens, pos),
                                              caches, positions)
        return self.final_ln(x), caches

    def copy_cache_rows(self, caches, src_slot, src_row, dst_slot,
                        dst_row, rows):
        """Copy ``rows`` KV rows between slots in every layer's cache, in
        place: the prefix-cache block copy."""
        return self.decoder.copy_cache_rows(
            caches, src_slot, src_row, dst_slot, dst_row, rows)


class GPTForCausalLM(HybridBlock):
    """Next-token LM head over GPTModel, weight-tied to the embedding.

    forward -> logits (b, s, vocab)
    """

    def __init__(self, backbone=None, device=None, **kwargs):
        super().__init__()
        self.backbone = backbone if backbone is not None \
            else GPTModel(device=device, **kwargs)

    def _head(self, h):
        # the reference's np.dot, dispatched (and cast by AMP) as "dot"
        h, w = amp._maybe_cast_op_inputs(
            "dot", (h, self.backbone.word_embed.weight))
        return torch.matmul(h, w.t())

    def forward(self, inputs):
        return self._head(self.backbone(inputs))

    # -- KV-cache serving surface (mx.serve) ---------------------------

    @property
    def max_length(self):
        return self.backbone.max_length

    def init_cache(self, max_slots, max_seq=None, dtype=torch.float32):
        return self.backbone.init_cache(max_slots, max_seq, dtype)

    # _head reads the embedding weight directly, not through a block's
    # call, so these two take the recording gate themselves
    @recording_gate
    def prefill(self, inputs, caches, slot):
        h, caches = self.backbone.prefill(inputs, caches, slot)
        return self._head(h), caches

    @recording_gate
    def decode_step(self, tokens, caches, positions):
        h, caches = self.backbone.decode_step(tokens, caches, positions)
        return self._head(h[:, 0]), caches

    @recording_gate
    def prefill_suffix(self, inputs, caches, slot, start):
        h, caches = self.backbone.prefill_suffix(inputs, caches, slot, start)
        return self._head(h), caches

    @recording_gate
    def decode_multi(self, tokens, caches, positions):
        h, caches = self.backbone.decode_multi(tokens, caches, positions)
        return self._head(h), caches

    def copy_cache_rows(self, caches, src_slot, src_row, dst_slot,
                        dst_row, rows):
        return self.backbone.copy_cache_rows(
            caches, src_slot, src_row, dst_slot, dst_row, rows)


def gpt2_124m(vocab_size=50257, **kwargs):
    """GPT-2 small: 12 layers, 768 units, 12 heads (117M-class)."""
    return GPTModel(vocab_size=vocab_size, units=768, hidden_size=3072,
                    num_layers=12, num_heads=12, **kwargs)


def gpt2_355m(vocab_size=50257, **kwargs):
    """GPT-2 medium: 24 layers, 1024 units, 16 heads (345M-class)."""
    return GPTModel(vocab_size=vocab_size, units=1024, hidden_size=4096,
                    num_layers=24, num_heads=16, **kwargs)
