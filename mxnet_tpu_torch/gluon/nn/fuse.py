"""Pattern-fused Sequential: conv3x3 + BatchNorm + ReLU triplets through
kernel 8.

Counterpart of ``mxnet_tpu/gluon/nn/fuse.py``: ``FusableSequential``
(:66), ``_eligible_triplet`` (:47) and ``_has_hooks`` (:41). During
training, a run of [Conv2D 3x3 / stride 1 / SAME / no bias, BatchNorm
(scale, center, batch statistics, axis 1), Activation("relu")] goes through
``npx.fused_conv_bn_relu``, whose backward is kernel 8
(``ops/conv_bwd.py``), with the children's own parameters; everything else
runs child by child.

The ``fused_conv_bn`` knob (``config.py``): "off" never fuses; "on" always
fuses an eligible triplet in training (on the CPU through the kernel's
plain version); "auto" fuses it for a CUDA tensor whose triplet runs in a
dtype of ``_AUTO_DTYPES``. That dtype is the one after the AMP policy:
under ``amp.init("bfloat16")`` ``npx.fused_conv_bn_relu`` casts x, w,
gamma and beta to bf16 (a target op, as in the reference), although x
arrives in fp32 from the previous fp32 BatchNorm. The reference's
"auto" is off, from an A/B on a TPU v5e (``fuse.py:33-38``), a TPU fact
that is not carried over: on the card "auto" takes the kernel, as
``fused_ln_residual``'s "auto" does. Eval, a CPU tensor under "auto",
forward hooks on a child (the fused route does not call the children) and
CUDA shapes the kernel does not take (``conv_bwd.fits_card``) all run child
by child. The choice is made by these rules before anything runs, never by
catching a failure.
"""
from __future__ import annotations

import torch

from ... import amp, autograd, config
from ... import numpy_extension as npx
from ...base import MXNetError
from ...ops import conv_bwd
from .basic_layers import Activation, BatchNorm, HybridSequential, _ready
from .conv_layers import _Conv

__all__ = ["FusableSequential"]

# the dtypes "auto" fuses on the card, by the ResNet-50 step on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md): fp32 (kernel 8 level with cuDNN's
# fp32 chain). Not bf16: the bf16 step took 40.5 device ms with the bf16
# kernel ("on") against 37.9 with cuDNN's bf16 chain ("off"), so "auto"
# leaves bf16 triplets to cuDNN
_AUTO_DTYPES = (torch.float32,)


def _fusion_active(x):
    """Whether the knob fuses eligible triplets on input ``x`` now."""
    if not autograd.is_training():
        return False
    mode = str(config.get("fused_conv_bn")).lower()
    if mode not in ("auto", "on", "off"):
        raise MXNetError(f"fused_conv_bn must be 'auto', 'on' or 'off', got "
                         f"{mode!r}")
    if mode == "auto":
        dtype = amp._op_cast_dtype("fused_conv_bn_relu") or x.dtype
        return x.device.type == "cuda" and dtype in _AUTO_DTYPES
    return mode == "on"


def _has_hooks(*blocks):
    return any(getattr(b, attr, None)
               for b in blocks
               for attr in ("_forward_hooks", "_forward_pre_hooks"))


def _eligible_triplet(conv, bn, act):
    if not (isinstance(conv, _Conv) and type(bn) is BatchNorm
            and isinstance(act, Activation)
            and getattr(act, "_act_type", None) == "relu"):
        return False
    if conv._op_name != "convolution" or conv._layout != "NCHW" \
            or conv.act is not None:
        return False
    if not (bn._scale and bn._center and not bn._use_global_stats
            and bn._axis == 1):
        return False
    if _has_hooks(conv, bn, act):
        # the fused route does not call the children: keep hooks observable
        return False
    return conv_bwd.eligible(conv._kernel, conv._strides, conv._padding,
                             conv._dilation, conv._groups,
                             conv.bias is not None)


class FusableSequential(HybridSequential):
    """HybridSequential that routes [Conv2D 3x3/s1, BatchNorm, ReLU] runs
    through ``npx.fused_conv_bn_relu`` while training (reference:
    fuse.py FusableSequential)."""

    def forward(self, x, *args):
        children = list(self._modules.values())
        fuse = _fusion_active(x)
        i = 0
        while i < len(children):
            blk = children[i]
            if (fuse and i + 2 < len(children)
                    and _eligible_triplet(blk, children[i + 1],
                                          children[i + 2])
                    and (x.device.type != "cuda"
                         or conv_bwd.fits_card(x, blk._channels))):
                conv, bn = blk, children[i + 1]
                _ready(conv.weight, (conv._channels, x.shape[1])
                       + conv._kernel)
                for p in (bn.gamma, bn.beta, bn.running_mean,
                          bn.running_var):
                    _ready(p, (conv._channels,))
                with bn.stats_scope():
                    x = npx.fused_conv_bn_relu(
                        x, conv.weight, bn.gamma, bn.beta, bn.running_mean,
                        bn.running_var, momentum=bn._momentum,
                        eps=bn._epsilon)
                i += 3
                continue
            x = blk(x, *args)
            args = ()
            i += 1
        return x
