"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` is the reference; this package keeps its
module paths and names so each counterpart is easy to find, uses PyTorch
idiom inside, and replaces each Pallas TPU kernel with a CUDA kernel
written by hand for ``sm_90a`` (``csrc/``, built at first use). It imports
nothing of JAX and nothing of ``mxnet_tpu``.

The array core is ``mx.np``: ``mx.np.ndarray`` wraps one ``torch.Tensor``
and every op goes through one ``_invoke`` (``numpy/multiarray.py``), with
the reference's 187-function surface, ``np.random`` and ``np.linalg``;
``mx.npx`` and every Gluon block take ``mx.np`` arrays and give them back.
Devices are ``Context``s (``mx.cpu()``, ``mx.gpu(i)`` is ``cuda:i``), and
``with ctx:`` sets the default.

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
unless given ``device="cpu"`` or called inside ``with mx.cpu():``.

The host planes are the reference's: ``telemetry`` (metrics, the ops
endpoint), ``fault`` (injection points), ``profiler`` (host spans and a
``torch.profiler`` device trace), ``trace`` (causal spans), ``goodput``
(the wall-clock ledger and burn rates), ``insight`` (cost, MFU, drift),
``blackbox`` (postmortem bundles), ``log`` and the sync guard of
``pipeline``; ``_invoke``, the layers' ops, ``hybridize()``, the Trainer
and the serve engine are hooked into them, each hook one attribute read
while its plane is off. ``profiler.autostart`` (``MXNET_PROFILER_
AUTOSTART``) starts the profiler at import.

The data and checkpoint path is the reference's: ``gluon.data``
(datasets, samplers with resumable cursors, the ``DataLoader`` with
thread or spawned process workers over a shared-memory ring), the vision
datasets and transforms over ``npx.image``, ``recordio`` (the same
``.rec`` bytes), the ``image`` codecs, ``stream`` (checksummed shards),
``pipeline.DevicePrefetcher`` (pinned memory, a side CUDA stream),
``resilience`` (``TrainState`` bundles with bit-for-bit resume, ``run``),
``io``'s iterators and ``gluon.contrib.estimator``.

Many processes train data parallel: ``tools/launch.py -n N`` starts the
ranks, and import joins them into a ``torch.distributed`` group
(``_dist_init``); ``parallel.collectives``, the ``dist_*`` and Horovod
stores under ``gluon.Trainer``, and ``parallel.ShardedTrainStep`` over
``dp`` with ZeRO-1/2, accumulation, remat and compressed gradients run
over it, and BatchNorm takes the global batch's statistics there.
"""
from ._dist_init import ensure_distributed as _ensure_distributed

# join the process group before anything touches a device (reference:
# mxnet_tpu/__init__.py); a no-op without the launcher's environment
_ensure_distributed()

from . import base, config, context  # noqa: E402
from . import log, telemetry, fault, profiler, trace, pipeline
from . import goodput, insight, blackbox
from . import numpy as np
from . import amp, autograd, contrib, dlpack, functional, gluon
from . import initializer, kvstore, lr_scheduler
from . import initializer as init
from . import kvstore as kv
from . import numpy_extension as npx
from . import optimizer, parallel, random, serve, test_utils, util
from . import image, io, recordio, resilience, stream
from .base import MXNetError
from .context import (Context, cpu, cpu_pinned, current_context, device, gpu,
                      num_gpus, resolve_device, tpu)
from .numpy_extension import waitall

__version__ = "2.0.0a1"

__all__ = ["Context", "MXNetError", "amp", "autograd", "blackbox", "config",
           "context", "contrib", "cpu", "cpu_pinned", "current_context",
           "device", "dlpack", "fault", "functional", "gluon", "goodput",
           "gpu", "image", "init", "initializer", "insight", "io", "kv",
           "kvstore", "log", "lr_scheduler",
           "np", "npx", "num_gpus", "optimizer", "parallel", "pipeline",
           "profiler", "random", "recordio", "resilience",
           "resolve_device", "serve", "stream", "telemetry",
           "test_utils", "tpu", "trace", "util", "waitall"]

if config.get("profiler.autostart"):
    profiler.set_state("run")
