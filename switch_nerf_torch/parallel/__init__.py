"""Data and expert parallelism for the port: one process per card under
``torchrun``.

  * ``host``: the process group (``init_distributed``) and the helpers the
    runner, the datasets, the meters and the checkpoints use (rank, world
    size, barriers, string and object exchange, global flag votes);
  * ``mesh``: the ('data', 'expert') mesh of ``--mesh_shape`` and
    ``--expert_parallel``, its sizes and its process groups;
  * ``chunks``: the global model-chunk grid of a training pass and the
    routing of a chunk that spans ranks;
  * ``experts``: the token exchange around the expert chain and the
    gathers of whole experts (expert parallelism).

Under data parallelism the parameters are replicated; under expert
parallelism each rank holds its block of experts. ``--batch_size`` is the
global batch, each rank trains on its share and ``trainer.TrainStep``
averages the gradients over the ranks.
"""
from switch_nerf_torch.parallel.host import (all_gather_object, all_true,
                                             any_true, barrier, broadcast_str,
                                             broadcast_tensors_, destroy,
                                             init_distributed, is_main,
                                             local_rank, rank, world_size)
from switch_nerf_torch.parallel.mesh import mesh_shape, setup as setup_mesh

__all__ = ["init_distributed", "destroy", "rank", "world_size", "local_rank",
           "is_main", "barrier", "broadcast_str", "broadcast_tensors_",
           "all_gather_object", "all_true", "any_true", "mesh_shape",
           "setup_mesh"]
