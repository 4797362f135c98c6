"""mx.parallel — meshes, collectives and the parallel training step.

Counterpart of ``mxnet_tpu/parallel/``: ``MeshConfig``, ``make_mesh`` and
the mesh helpers over the ranks of the ``torch.distributed`` group
(``tools/launch.py`` starts them, import joins them), a process group for
each line of ranks along each axis; the collectives (``allreduce``,
``allgather``, ``reduce_scatter``, ``ppermute``, ``compressed_allreduce``,
``allreduce_across_processes``); ``ShardedTrainStep`` over dp x tp x pp x
sp (ZeRO-1/2 and ZeRO×TP, ``grad_accum`` as the GPipe schedule under pp,
``steps_per_call``, ``remat``, compressed gradients, ``rebuild``),
``megatron_specs``, ``scan_steps``; tensor parallelism (``tp``), pipeline
parallelism (``pp``, ``gpipe``, ``stack_stage_params``, ``shard_stages``),
ring attention and the activation-sharding scope; and the scaling
harness.
"""
from .mesh import (  # noqa: F401
    P, MeshConfig, make_mesh, data_parallel_mesh, set_mesh, current_mesh,
    shard, replicate, mesh_factorizations, activation_sharding,
)
from .collectives import (  # noqa: F401
    allreduce, allgather, reduce_scatter, ppermute,
    allreduce_across_processes, compressed_allreduce,
)
from .ring_attention import ring_attention  # noqa: F401
from . import tp  # noqa: F401
from . import pp  # noqa: F401
from .pp import gpipe, stack_stage_params, shard_stages  # noqa: F401
from .train import ShardedTrainStep, megatron_specs, scan_steps  # noqa: F401
from .scaling import weak_scaling_table, multiprocess_overhead_table  # noqa: F401,E501
from .._dist_init import rank, world_size, backend, rank_device  # noqa: F401
