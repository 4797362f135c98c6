"""Gluon: blocks, parameters, layers, losses, metrics, utils, the trainer
and the model zoo."""
from . import loss, metric, model_zoo, nn, utils
from .block import HybridBlock
from .parameter import Constant, Parameter
from .trainer import Trainer

__all__ = ["Constant", "HybridBlock", "Parameter", "Trainer", "loss",
           "metric", "nn", "model_zoo", "utils"]
