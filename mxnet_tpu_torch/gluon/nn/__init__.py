"""Gluon layers (serving slice)."""
from .basic_layers import Dense, Dropout, Embedding, LayerNorm
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderCell)

__all__ = ["Dense", "Dropout", "Embedding", "LayerNorm",
           "MultiHeadAttention", "PositionwiseFFN", "TransformerEncoder",
           "TransformerEncoderCell"]
