"""Gluon: blocks, layers and the model zoo (serving slice)."""
from . import model_zoo, nn
from .block import HybridBlock

__all__ = ["HybridBlock", "nn", "model_zoo"]
