"""Gluon: blocks, parameters, layers, losses, the trainer and the model
zoo (serving and training slices)."""
from . import loss, model_zoo, nn
from .block import HybridBlock
from .parameter import Parameter
from .trainer import Trainer

__all__ = ["HybridBlock", "Parameter", "Trainer", "loss", "nn", "model_zoo"]
