"""Parameters as flat ``{structural name: numpy array}`` dictionaries.

Counterpart of ``mxnet_tpu/functional.py``'s ``param_arrays``, plus
:func:`load_params`, which carries a dictionary in that layout (for
example the JAX package's ``param_arrays`` converted to numpy) into a
port model. This module only ever sees numpy arrays. Optimizer state
carries across by name through ``gluon.Trainer.load_states_by_name``.
"""
from __future__ import annotations

import numpy as onp
import torch

from .base import MXNetError

__all__ = ["param_arrays", "load_params"]


def param_arrays(block):
    """dict structural-name -> numpy copy of every parameter."""
    return {name: p.data().detach().cpu().numpy()
            for name, p in block.collect_params().items()}


@torch.no_grad()
def load_params(block, arrays):
    """Copy ``arrays`` ({structural name: numpy array}) into ``block``'s
    parameters on their own device and dtype. Raises :class:`MXNetError`
    on any missing, extra or mis-shaped name, before anything is copied."""
    params = block.collect_params()
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    shaped = sorted(n for n in set(params) & set(arrays)
                    if tuple(onp.shape(arrays[n])) != params[n].shape)
    if missing or extra or shaped:
        bad_shapes = [(n, tuple(onp.shape(arrays[n])),
                       tuple(params[n].shape)) for n in shaped[:4]]
        raise MXNetError(
            f"load_params: parameters do not match the model "
            f"(missing={missing[:4]}, extra={extra[:4]}, "
            f"mis-shaped={bad_shapes})")
    for name, p in params.items():
        p.set_data(torch.tensor(onp.asarray(arrays[name])))
    return block
