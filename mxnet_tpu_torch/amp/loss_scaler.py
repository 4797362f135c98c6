"""Dynamic loss scaler (reference: python/mxnet/amp/loss_scaler.py:26-60).

Counterpart of ``mxnet_tpu/amp/loss_scaler.py``. :func:`all_finite` is
the gradient check of the scaler and of the Trainer's non-finite guard:
one multi-tensor reduction on the device (the max |value| of every
gradient, which is NaN or inf exactly where a gradient holds one and can
not overflow on finite values) and one host read, where the JAX package
copies every gradient to the host.
"""
from __future__ import annotations

import math

import torch

__all__ = ["LossScaler", "all_finite"]


def all_finite(tensors):
    """Whether every value of every tensor in ``tensors`` is finite: one
    reduction over all of them, one host read (True for none)."""
    tensors = list(tensors)
    if not tensors:
        return True
    norms = torch._foreach_norm(tensors, math.inf)
    return bool(torch.stack([n.float() for n in norms]).isfinite().all())


def _grads(params):
    return [p.data().grad for p in params
            if p.grad_req != "null" and p.data().grad is not None]


class LossScaler:
    """The loss scale and its backoff window: halve (``scale_factor``) on
    an overflow, down to 1; grow after ``scale_window`` clean steps."""

    def __init__(self, init_scale=2 ** 16, scale_factor=2.0,
                 scale_window=2000, tolerance=0.05):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0

    def has_overflow(self, params):
        """Whether a gradient of ``params`` (Gluon parameters) holds an inf
        or NaN (reference: loss_scaler.py has_overflow)."""
        return not all_finite(_grads(params))

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped == self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0

    # the scale and its backoff window are training state: a resumed run
    # that lost them would replay the warm-up
    def state_dict(self):
        return {"loss_scale": self.loss_scale, "unskipped": self._unskipped,
                "scale_factor": self._scale_factor,
                "scale_window": self._scale_window}

    def load_state_dict(self, state):
        self.loss_scale = state["loss_scale"]
        self._unskipped = int(state.get("unskipped", 0))
        self._scale_factor = state.get("scale_factor", self._scale_factor)
        self._scale_window = state.get("scale_window", self._scale_window)
