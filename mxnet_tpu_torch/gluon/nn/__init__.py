"""Gluon layers (serving, training and ResNet slices)."""
from . import conv_layers
from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           Flatten, HybridSequential, LayerNorm)
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D
from .fuse import FusableSequential
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerEncoder, TransformerEncoderCell,
                          valid_length_mask)

__all__ = ["Activation", "BatchNorm", "Conv2D", "Dense", "Dropout",
           "Embedding", "Flatten", "FusableSequential", "GlobalAvgPool2D",
           "HybridSequential", "LayerNorm", "MaxPool2D", "MultiHeadAttention",
           "PositionwiseFFN", "TransformerEncoder", "TransformerEncoderCell",
           "valid_length_mask"]
