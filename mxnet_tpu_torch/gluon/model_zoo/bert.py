"""BERT model family.

Counterpart of ``mxnet_tpu/gluon/model_zoo/bert.py`` (gluon-nlp's
BERTModel / BERTForPretraining layout): word, token-type and position
embeddings, a post-norm ``TransformerEncoder`` whose cells route
``LN(x + dropout(h))`` through the fused ln_residual kernels, a tanh
pooler, and the MLM (decoder tied to ``word_embed.weight`` plus its own
``mlm_bias``) and NSP heads. A ``valid_length`` masks padded keys, so
attention takes the plain composition, as it does under live attention
dropout (``ops/attention.py``). Parameter names are the JAX package's, so
``functional.load_params`` carries its ``param_arrays`` across unchanged.
Each constructor takes a ``device``: ``None`` means ``cuda:0`` and raises
without CUDA.
"""
from __future__ import annotations

import torch

from ... import amp
from ... import numpy_extension as npx
from ...context import resolve_device
from ..block import HybridBlock
from ..nn import Dense, Dropout, Embedding, LayerNorm
from ..nn.transformer import TransformerEncoder, valid_length_mask
from ..parameter import Parameter

__all__ = ["BERTModel", "BERTForPretraining", "bert_12_768_12",
           "bert_24_1024_16", "bert_base", "bert_large"]


class BERTModel(HybridBlock):
    """BERT encoder with pooler.

    forward(inputs, token_types, valid_length) ->
        (sequence_output (b, s, units), pooled_output (b, units))
    """

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 token_type_vocab_size=2, dropout=0.1, embed_dropout=0.1,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self._units = units
        self.word_embed = Embedding(vocab_size, units, device=device)
        self.token_type_embed = Embedding(token_type_vocab_size, units,
                                          device=device)
        self.position_embed = Embedding(max_length, units, device=device)
        self.embed_ln = LayerNorm(epsilon=1e-12, in_channels=units,
                                  device=device)
        self.embed_dropout = Dropout(embed_dropout) if embed_dropout else None
        self.encoder = TransformerEncoder(
            num_layers, units, hidden_size, num_heads, dropout=dropout,
            attention_dropout=dropout, activation="gelu", pre_norm=False,
            device=device)
        self.pooler = Dense(units, activation="tanh", flatten=False,
                            in_units=units, device=device)

    def forward(self, inputs, token_types=None, valid_length=None):
        b, s = inputs.shape
        if token_types is None:
            token_types = torch.zeros((b, s), dtype=torch.long,
                                      device=inputs.device)
        pos = torch.arange(s, device=inputs.device).reshape(1, s)
        x = (self.word_embed(inputs) + self.token_type_embed(token_types)
             + self.position_embed(pos))
        x = self.embed_ln(x)
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        mask = None
        if valid_length is not None:
            mask = valid_length_mask(valid_length, s)
        seq = self.encoder(x, mask=mask)
        return seq, self.pooler(seq[:, 0, :])


class BERTForPretraining(HybridBlock):
    """MLM + NSP heads on BERTModel (gluon-nlp BERTForPretraining).

    forward -> (mlm_scores (b, s, vocab), nsp_scores (b, 2))
    """

    def __init__(self, backbone=None, device=None, **kwargs):
        super().__init__()
        self.backbone = backbone if backbone is not None \
            else BERTModel(device=device, **kwargs)
        units = self.backbone._units
        device = self.backbone.device
        # decoder projection: weight tied to word_embed in forward, with its
        # own per-vocab bias (first in collect_params, as in the reference)
        vocab = self.backbone.word_embed.weight.shape[0]
        self.mlm_bias = Parameter((vocab,), device=device).data()
        self.mlm_dense = Dense(units, flatten=False, in_units=units,
                               device=device)
        self.mlm_ln = LayerNorm(epsilon=1e-12, in_channels=units,
                                device=device)
        self.nsp_classifier = Dense(2, flatten=False, in_units=units,
                                    device=device)

    def forward(self, inputs, token_types=None, valid_length=None):
        seq, pooled = self.backbone(inputs, token_types, valid_length)
        h = self.mlm_ln(npx.leaky_relu(self.mlm_dense(seq), act_type="gelu"))
        # tied decoder: logits = h @ word_embed.weight.T + bias
        # the reference's np.dot, dispatched (and cast by AMP) as "dot"
        hd, w = amp._maybe_cast_op_inputs(
            "dot", (h, self.backbone.word_embed.weight))
        mlm_scores = torch.matmul(hd, w.t()) + self.mlm_bias
        return mlm_scores, self.nsp_classifier(pooled)


def bert_12_768_12(vocab_size=30522, **kwargs):
    """BERT-base (gluon-nlp model name)."""
    return BERTModel(vocab_size=vocab_size, units=768, hidden_size=3072,
                     num_layers=12, num_heads=12, **kwargs)


def bert_24_1024_16(vocab_size=30522, **kwargs):
    """BERT-large (gluon-nlp model name)."""
    return BERTModel(vocab_size=vocab_size, units=1024, hidden_size=4096,
                     num_layers=24, num_heads=16, **kwargs)


bert_base = bert_12_768_12
bert_large = bert_24_1024_16
