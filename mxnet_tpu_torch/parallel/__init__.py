"""mx.parallel — meshes, collectives and the data-parallel training step.

Counterpart of ``mxnet_tpu/parallel/``: ``MeshConfig``, ``make_mesh`` and
the mesh helpers over the ranks of the ``torch.distributed`` group
(``tools/launch.py`` starts them, import joins them), the collectives
(``allreduce``, ``allgather``, ``reduce_scatter``, ``ppermute``,
``compressed_allreduce``, ``allreduce_across_processes``),
``ShardedTrainStep`` over ``dp`` with ZeRO-1/2, ``grad_accum``,
``steps_per_call``, ``remat`` and compressed gradients, ``scan_steps``,
and the scaling harness. Tensor, pipeline and sequence parallelism
(``tp``, ``pp``, ``gpipe``, ring attention, ``megatron_specs``) are
slice 22 of the port.
"""
from .mesh import (  # noqa: F401
    P, MeshConfig, make_mesh, data_parallel_mesh, set_mesh, current_mesh,
    shard, replicate, mesh_factorizations,
)
from .collectives import (  # noqa: F401
    allreduce, allgather, reduce_scatter, ppermute,
    allreduce_across_processes, compressed_allreduce,
)
from .train import ShardedTrainStep, scan_steps  # noqa: F401
from .scaling import weak_scaling_table, multiprocess_overhead_table  # noqa: F401,E501
from .._dist_init import rank, world_size, backend, rank_device  # noqa: F401
