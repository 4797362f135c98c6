"""Gluon: blocks, parameters, layers, recurrent networks, losses, metrics,
utils, the trainer, the model zoo, ``data`` and ``contrib`` (the
estimator, ``contrib.nn``)."""
from . import contrib, data, loss, metric, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock
from .parameter import Constant, DeferredInitializationError, Parameter
from .trainer import Trainer

__all__ = ["Block", "Constant", "DeferredInitializationError",
           "HybridBlock", "Parameter", "Trainer", "contrib", "data", "loss",
           "metric", "nn", "model_zoo", "rnn", "utils"]
