"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` is the reference; this package keeps its
module paths and names so each counterpart is easy to find, uses PyTorch
idiom inside, and replaces each Pallas TPU kernel with a CUDA kernel
written by hand for ``sm_90a`` (``csrc/``, built at first use). It imports
nothing of JAX and nothing of ``mxnet_tpu``.

The ported slices are serving (``serve.load(GPTForCausalLM(...))``, prefill
attention through the flash-attention forward kernel) and training
(``autograd.record()`` -> ``autograd.backward(loss)`` ->
``gluon.Trainer.step``, attention gradients through the two
flash-attention backward kernels), BERT training (the ln_residual kernels)
and fp8 training (``parallel.ShardedTrainStep(..., precision="fp8")``, the
fp8 matmul kernel on every eligible Dense), int8 inference
(``contrib.quantization.quantize_net``, the int8 matmul kernel on every
quantized Dense, exact int8 convolutions) and ResNet training through
Gluon (``gluon.model_zoo.vision``, the conv3x3+BN+ReLU backward kernel in
every eligible triplet of an ``nn.FusableSequential``), and bf16 mixed
precision on those training paths (``amp.init("bfloat16")``, or
``Block.cast`` with ``multi_precision``). Entry points run on ``cuda:0``
unless given ``device="cpu"``.
"""
from . import amp, autograd, config, context, contrib, functional, gluon
from . import initializer, lr_scheduler
from . import numpy_extension as npx
from . import optimizer, parallel, random, serve
from .base import MXNetError
from .context import resolve_device

__version__ = "2.0.0a1"

__all__ = ["MXNetError", "amp", "autograd", "config", "context", "contrib",
           "functional", "gluon", "initializer", "lr_scheduler", "npx",
           "optimizer", "parallel", "random", "resolve_device", "serve"]
