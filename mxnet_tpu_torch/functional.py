"""Functional execution of Gluon blocks, and parameters as flat
``{structural name: numpy array}`` dictionaries.

Counterpart of ``mxnet_tpu/functional.py``: :func:`split_params` and
:func:`functional_call` (a block method as a function of a parameter
dictionary, over ``torch.func.functional_call``; the structural names are
the ``nn.Module`` parameter names), ``param_arrays``, plus
:func:`load_params`, which carries a dictionary of numpy arrays (for
example the JAX package's ``param_arrays`` converted to numpy) into a
port model. Optimizer state carries across by name through
``gluon.Trainer.load_states_by_name``. ``Packer`` is not ported yet.
"""
from __future__ import annotations

import numpy as onp
import torch

from . import autograd as _autograd
from . import random as _random
from .base import MXNetError
from .gluon.cached_graph import plain_scope

__all__ = ["param_arrays", "load_params", "split_params", "functional_call"]


def _holds_values(p):
    return p.initialized and p._shape_known()


def param_arrays(block):
    """dict structural-name -> numpy copy of every parameter that holds
    values (a deferred one, whose first forward has not run, or one never
    initialized is left out, as the reference leaves out parameters without
    data). A copy on the CPU too, where ``Tensor.numpy()`` would share the
    parameter's memory and follow its in-place updates. bf16, which numpy
    lacks, comes widened to fp32 (exactly: ``load_params`` rounds it back
    into a bf16 parameter)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return {name: host(p.data())
            for name, p in block.collect_params().items()
            if _holds_values(p)}


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


def split_params(block):
    """``(trainable, aux)``: {structural name: tensor} of every parameter
    that holds values, aux being those with ``grad_req="null"`` (BatchNorm's
    running statistics), as the reference's ``split_params``. The tensors
    are the parameters' own (``Parameter.data()``)."""
    trainable, aux = {}, {}
    for name, p in block.collect_params().items():
        if _holds_values(p):
            (aux if p.grad_req == "null" else trainable)[name] = p.data()
    return trainable, aux


class _Method(torch.nn.Module):
    """``block.<method>`` as a module's forward, for
    ``torch.func.functional_call``."""

    def __init__(self, block, method):
        super().__init__()
        self.block = block
        self._method = method

    def forward(self, *args):
        return getattr(self.block, self._method)(*args)


def functional_call(block, params, *args, train=False, generator=None,
                    method="forward"):
    """Run ``block.<method>`` (``forward`` by default, or a serving entry
    such as ``prefill``) on ``args`` with the tensors of ``params``
    ({structural name: tensor}; names it lacks keep the block's own) in
    place of the parameters, and return ``(outputs, mutated)``: ``mutated``
    holds the aux values the call updated (BatchNorm's running statistics
    while ``train``), which the caller threads on, as the reference's
    ``functional_call`` returns them. The block's parameters and the
    tensors of ``params`` are left as they were (aux values are updated in
    copies).

    ``train`` sets ``autograd.is_training()`` (live dropout, batch
    statistics); ``generator`` (a ``torch.Generator``, the reference's
    ``rng_key``) is the default generator of its device for the call. The
    call is differentiable with respect to ``params`` unless grad mode is
    off (``torch.no_grad()``). Hybridized blocks run their plain
    forward inside it."""
    block_params = block.collect_params()
    unknown = sorted(set(params) - set(block_params))
    if unknown:
        raise MXNetError(f"functional_call: unknown parameters "
                         f"{unknown[:4]}")
    for name in params:
        if not block_params[name]._shape_known():
            raise MXNetError(f"parameter {name} has no values yet (its "
                             "shape is deferred); run a forward first")
    values, copies = {}, {}
    for name, v in params.items():
        v = torch.as_tensor(v)
        if block_params[name].grad_req == "null":
            v = copies[name] = v.detach().clone()
        else:
            v = v.view_as(v)  # a tensor of its own for the back-reference
        # layers reach a tensor's Parameter through it (deferred shapes,
        # grad_req)
        v._mx_param = block_params[name]
        values["block." + name] = v
    versions = {n: c._version for n, c in copies.items()}
    with plain_scope(), _random.generator_scope(generator), \
            _autograd._RecordingStateScope(torch.is_grad_enabled(), train):
        out = torch.func.functional_call(_Method(block, method), values,
                                         args)
    mutated = {n: c for n, c in copies.items()
               if c._version != versions[n]}
    return out, mutated
