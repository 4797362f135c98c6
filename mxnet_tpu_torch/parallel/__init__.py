"""mx.parallel — meshes and the training step, one card.

Counterpart of ``mxnet_tpu/parallel/``: ``MeshConfig``, ``make_mesh`` and
``ShardedTrainStep`` for the one-card layout. Collectives, tensor, pipeline
and sequence parallelism, ZeRO and gradient compression across cards come
with the multi-card slice.
"""
from .mesh import MeshConfig, P, make_mesh  # noqa: F401
from .train import ShardedTrainStep  # noqa: F401
