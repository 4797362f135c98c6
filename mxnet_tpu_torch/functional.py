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
    """dict structural-name -> numpy copy of every parameter whose shape is
    known (a deferred one, whose first forward has not run, is left out, as
    the reference leaves out parameters without data). A copy on the CPU
    too, where ``Tensor.numpy()`` would share the parameter's memory and
    follow its in-place updates. bf16, which numpy lacks, comes widened to
    fp32 (exactly: ``load_params`` rounds it back into a bf16 parameter)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return {name: host(p.data())
            for name, p in block.collect_params().items()
            if p._shape_known()}


def _fits(shape, array_shape):
    """Whether an array of ``array_shape`` fills a parameter of ``shape``
    (0: a deferred dimension, any size)."""
    return len(shape) == len(array_shape) and all(
        s in (0, a) for s, a in zip(shape, array_shape))


@torch.no_grad()
def load_params(block, arrays):
    """Copy ``arrays`` ({structural name: numpy array}) into ``block``'s
    parameters on their own device and dtype; a deferred parameter takes
    the array's shape where it fits (its unknown, 0, dimensions). Raises
    :class:`MXNetError` on any missing, extra or mis-shaped name, before
    anything is copied."""
    params = block.collect_params()
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    shaped = sorted(n for n in set(params) & set(arrays)
                    if not _fits(params[n].shape, onp.shape(arrays[n])))
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
