"""Contributed modules: int8 post-training quantization
(``quantization``), and the vocabulary and token embeddings (``text``)."""
from . import quantization, text

__all__ = ["quantization", "text"]
