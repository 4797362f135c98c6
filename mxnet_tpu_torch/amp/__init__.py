"""mx.amp: mixed precision.

Counterpart of ``mxnet_tpu/amp/`` (reference: python/mxnet/amp/: op-list
driven input casts at the operator wrappers, amp.py:105-246, the fp16/bf16
lists, ``convert_hybrid_block``, the dynamic ``LossScaler``), and fp8
training (:mod:`.fp8`).

``init`` installs a thread-local dtype policy. Every port op that the JAX
package dispatches under a name passes its floating inputs through
:func:`_maybe_cast_op_inputs` under that name (the JAX package applies
the same policy in ``_invoke``): the inputs of an op in
``lists.TARGET_DTYPE_OPS`` are cast to the target dtype, those of an op in
``lists.FP32_OPS`` (or a conditional entry) to float32, everything else
runs in the dtype it is given. The cast is ``tensor.to(dtype)`` inside the
recorded graph, so each gradient comes back in its input's own dtype: fp32
parameters stay the master weights. ``convert_symbol`` waits for the
port's Symbol.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..base import torch_dtype
from . import fp8  # noqa: F401
from . import lists
from .loss_scaler import LossScaler

__all__ = ["init", "is_active", "target_dtype", "convert_hybrid_block",
           "scale_loss", "unscale", "LossScaler", "lists", "fp8"]

_state = threading.local()

_TARGET_OPS = frozenset(lists.TARGET_DTYPE_OPS)
_FP32_OPS = frozenset(lists.FP32_OPS) | lists.conditional_fp32_names()
# lists.WIDEST_TYPE_CASTS documents the combiners that rely on dtype
# promotion for the widest input: torch promotes as jnp does (bf16 with
# fp32 gives fp32), so no hook is needed


def _norm_conditional(ops):
    """User-supplied conditional entries: (op, attr, [values]) triples or
    plain names -> dispatch-name set."""
    out = set()
    for item in ops or ():
        if isinstance(item, str):
            out.add(item)
        else:
            op, _attr, values = item
            out.update(f"{op}:{v}" for v in values)
    return out


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Install the dtype policy for this thread (reference: amp.init)."""
    _state.dtype = torch_dtype(target_dtype)
    _state.target_ops = _TARGET_OPS | set(target_precision_ops or ())
    _state.fp32_ops = (_FP32_OPS | set(fp32_ops or ())
                       | _norm_conditional(conditional_fp32_ops))
    _state.active = True


def _deactivate():
    """Turn the policy off (test isolation; the reference has no off
    switch)."""
    _state.active = False


def is_active():
    return getattr(_state, "active", False)


def target_dtype():
    return getattr(_state, "dtype", torch.bfloat16)


def _op_cast_dtype(name):
    """The dtype the op dispatched as ``name`` casts its floating inputs
    to under the active policy, or None."""
    if not getattr(_state, "active", False):
        return None
    if name in _state.target_ops:
        return _state.dtype
    if name in _state.fp32_ops:
        return torch.float32
    return None


def _maybe_cast_op_inputs(name, tensors):
    """``tensors`` with each floating tensor cast by the policy for the op
    dispatched as ``name`` (others, and everything while the policy is off,
    as they are)."""
    dt = _op_cast_dtype(name)
    if dt is None:
        return tensors
    return [t.to(dt) if isinstance(t, torch.Tensor) and t.is_floating_point()
            else t for t in tensors]


def convert_hybrid_block(block, target_dtype="bfloat16", ctx=None,
                         cast_params_offline=True, **kwargs):
    """Cast a block's parameters to ``target_dtype`` (reference:
    amp.convert_hybrid_block); gamma, beta and the running statistics stay
    fp32."""
    dt = torch_dtype(target_dtype)
    for name, p in block.collect_params().items():
        if name.endswith(("gamma", "beta", "running_mean", "running_var")):
            continue
        p.cast(dt)
    return block


def scale_loss(loss, trainer):
    """Scope yielding the loss (or list of losses) times the trainer's loss
    scale, attaching a :class:`LossScaler` to the trainer on first use
    (reference: amp.scale_loss); the trainer's non-finite guard then runs
    on every step."""
    @contextlib.contextmanager
    def _scope():
        scaler = getattr(trainer, "_amp_loss_scaler", None)
        if scaler is None:
            scaler = LossScaler()
            trainer._amp_loss_scaler = scaler
        if isinstance(loss, (list, tuple)):
            yield [l * scaler.loss_scale for l in loss]
        else:
            yield loss * scaler.loss_scale
    return _scope()


@torch.no_grad()
def unscale(trainer):
    """Divide every gradient of the trainer's parameters by the loss scale,
    in place (reference: amp.unscale)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    inv = 1.0 / scaler.loss_scale
    for p in trainer._params:
        if p.grad_req != "null" and p.data().grad is not None:
            p.data().grad.mul_(inv)
