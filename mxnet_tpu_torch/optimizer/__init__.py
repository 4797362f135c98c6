"""mx.optimizer (training slice): the registry, SGD, Adam, AdamW and the
Updater, with the reference's update arithmetic in plain PyTorch."""
from .optimizer import (Adam, AdamW, Optimizer, SGD, Updater, create,
                        get_updater, register)

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "Updater", "register",
           "create", "get_updater"]
