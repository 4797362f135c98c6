"""mx.optimizer: the registry, the reference's twenty optimizers and the
Updater, with the reference's update arithmetic in plain PyTorch."""
from . import contrib
from .contrib import GroupAdaGrad
from .optimizer import (DCASGD, FTML, LAMB, LANS, LARS, NAG, SGD, SGLD,
                        AdaBelief, AdaDelta, AdaGrad, Adam, Adamax, AdamW,
                        Ftrl, Nadam, Optimizer, RMSProp, Signum, Test,
                        Updater, create, get_updater, register)

__all__ = ["Optimizer", "Test", "SGD", "NAG", "Signum", "SGLD", "Adam",
           "AdamW", "Adamax", "FTML", "AdaBelief", "Nadam", "AdaGrad",
           "AdaDelta", "RMSProp", "Ftrl", "LAMB", "LANS", "LARS", "DCASGD",
           "GroupAdaGrad", "Updater", "register", "create", "get_updater",
           "contrib"]
