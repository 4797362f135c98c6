"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` is the reference; this package keeps its
module paths and names so each counterpart is easy to find, uses PyTorch
idiom inside, and replaces each Pallas TPU kernel with a CUDA kernel
written by hand for ``sm_90a`` (``csrc/``, built at first use). It imports
nothing of JAX and nothing of ``mxnet_tpu``.

This slice covers the serving path: ``serve.load(GPTForCausalLM(...))``
with prefill attention through the flash-attention forward kernel.
Entry points run on ``cuda:0`` unless given ``device="cpu"``.
"""
from . import config, context, functional, gluon, initializer
from . import numpy_extension as npx
from . import random, serve
from .base import MXNetError
from .context import resolve_device

__version__ = "2.0.0a1"

__all__ = ["MXNetError", "config", "context", "functional", "gluon",
           "initializer", "npx", "random", "resolve_device", "serve"]
