"""Gluon: blocks, parameters, layers, losses, metrics, utils, the trainer,
the model zoo, ``data`` and ``contrib.estimator``."""
from . import contrib, data, loss, metric, model_zoo, nn, utils
from .block import HybridBlock
from .parameter import Constant, Parameter
from .trainer import Trainer

__all__ = ["Constant", "HybridBlock", "Parameter", "Trainer", "contrib",
           "data", "loss", "metric", "nn", "model_zoo", "utils"]
