"""Gluon layers (serving and training slices)."""
from .basic_layers import Activation, Dense, Dropout, Embedding, LayerNorm
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderCell,
                          valid_length_mask)

__all__ = ["Activation", "Dense", "Dropout", "Embedding", "LayerNorm",
           "MultiHeadAttention", "PositionwiseFFN", "TransformerEncoder",
           "TransformerEncoderCell", "valid_length_mask"]
