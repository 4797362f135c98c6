"""Contributed modules: int8 post-training quantization (``quantization``)."""
from . import quantization

__all__ = ["quantization"]
