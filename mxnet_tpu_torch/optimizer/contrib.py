"""Contrib optimizers.

Counterpart of ``mxnet_tpu/optimizer/contrib.py``: ``GroupAdaGrad``,
AdaGrad with one history cell per row (the embedding-training optimizer:
O(rows) state instead of O(elements)). A row-sparse gradient updates
its rows only (it is lazy by construction, as in the reference); a dense
gradient updates every row.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ndarray.sparse import _rows_of, _set_rows
from .optimizer import Optimizer, register

__all__ = ["GroupAdaGrad"]


@register
class GroupAdaGrad(Optimizer):
    """AdaGrad with row-wise accumulators (reference: contrib.py
    ``GroupAdaGrad``): ``hist += mean(g^2, axis=1)``, ``w -= lr * g /
    (sqrt(hist) + eps)``. Weight decay is not supported (the reference
    raises too)."""

    def __init__(self, learning_rate=0.01, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon
        self.lazy_update = True

    def create_state(self, index, weight):
        if weight.ndim != 2:
            raise MXNetError(
                "GroupAdaGrad expects 2-D (row-partitioned) weights, got "
                f"shape {tuple(weight.shape)}")
        return torch.zeros((weight.shape[0], 1), dtype=weight.dtype,
                           device=weight.device)

    def _update_impl(self, index, w, g, hist, lr, wd):
        if wd != 0:
            raise MXNetError("Weight decay is not supported for "
                             "GroupAdaGrad")
        g = self._prep_grad(g)
        hist.add_((g * g).mean(dim=1, keepdim=True))
        w.addcdiv_(g, hist.sqrt().add_(self.epsilon), value=-lr)

    def _lazy_update_impl(self, index, w, rsp, hist, lr, wd):
        """The rule on ``rsp``'s rows of the weight and the history
        (reference: contrib.py ``_lazy_update_impl``, group_adagrad_update's
        sparse path)."""
        if wd != 0:
            raise MXNetError("Weight decay is not supported for "
                             "GroupAdaGrad")
        idx = rsp.indices._data
        g = self._prep_grad(rsp.data._data.to(w.dtype))
        h_rows = _rows_of(hist, idx).add_((g * g).mean(dim=1, keepdim=True))
        _set_rows(hist, idx, h_rows)
        w_rows = _rows_of(w, idx).addcdiv_(g, h_rows.sqrt().add_(
            self.epsilon), value=-lr)
        _set_rows(w, idx, w_rows)
