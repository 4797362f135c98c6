"""Gluon layers (reference: gluon/nn/__init__.py)."""
from . import conv_layers
from .activations import ELU, GELU, SELU, LeakyReLU, PReLU, SiLU, Swish
from .basic_layers import (Activation, BatchNorm, BatchNormReLU, Concatenate,
                           Dense, Dropout, Embedding, Flatten, GroupNorm,
                           HybridConcatenate, HybridLambda, HybridSequential,
                           Identity, InstanceNorm, Lambda, LayerNorm,
                           Sequential, SyncBatchNorm)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D,
                          Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                          Conv3DTranspose, DeformableConvolution,
                          GlobalAvgPool1D, GlobalAvgPool2D, GlobalAvgPool3D,
                          GlobalMaxPool1D, GlobalMaxPool2D, GlobalMaxPool3D,
                          MaxPool1D, MaxPool2D, MaxPool3D,
                          ModulatedDeformableConvolution, PixelShuffle1D,
                          PixelShuffle2D, PixelShuffle3D, ReflectionPad2D)
from .fuse import FusableSequential
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerDecoderCell, TransformerEncoder,
                          TransformerEncoderCell, positional_encoding,
                          valid_length_mask)
from ..block import HybridBlock

__all__ = ["Activation", "AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm",
           "BatchNormReLU", "Concatenate", "Conv1D", "Conv1DTranspose",
           "Conv2D", "Conv2DTranspose", "Conv3D", "Conv3DTranspose",
           "DeformableConvolution", "Dense", "Dropout", "ELU", "Embedding",
           "Flatten", "FusableSequential", "GELU", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GroupNorm", "HybridBlock",
           "HybridConcatenate", "HybridLambda", "HybridSequential",
           "Identity", "InstanceNorm", "Lambda", "LayerNorm", "LeakyReLU",
           "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "ModulatedDeformableConvolution", "MultiHeadAttention", "PReLU",
           "PixelShuffle1D", "PixelShuffle2D", "PixelShuffle3D",
           "PositionwiseFFN", "ReflectionPad2D", "SELU", "Sequential",
           "SiLU", "Swish", "SyncBatchNorm", "TransformerDecoderCell",
           "TransformerEncoder", "TransformerEncoderCell",
           "positional_encoding", "valid_length_mask"]
