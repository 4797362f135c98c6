"""mx.amp — mixed precision.

Counterpart of ``mxnet_tpu/amp/``; this slice of the port carries fp8
training (:mod:`.fp8`). The bf16 cast policy (``init``), the op lists and
the ``LossScaler`` come with the bf16/AMP slice.
"""
from . import fp8  # noqa: F401
