"""Data parallelism for the port: one process per card under ``torchrun``.

  * ``host``: the process group (``init_distributed``) and the helpers the
    runner, the datasets, the meters and the checkpoints use (rank, world
    size, barriers, string and object exchange, global flag votes);
  * ``mesh``: the ``--mesh_shape`` / expert-parallel flags, of which the
    port accepts the pure data-parallel ones.

Parameters are replicated, ``--batch_size`` is the global batch, each
rank trains on its share and ``trainer.TrainStep`` averages the gradients
over the ranks.
"""
from switch_nerf_torch.parallel.host import (all_gather_object, all_true,
                                             any_true, barrier, broadcast_str,
                                             broadcast_tensors_, destroy,
                                             init_distributed, is_main,
                                             local_rank, rank, world_size)
from switch_nerf_torch.parallel.mesh import check_data_parallel

__all__ = ["init_distributed", "destroy", "rank", "world_size", "local_rank",
           "is_main", "barrier", "broadcast_str", "broadcast_tensors_",
           "all_gather_object", "all_true", "any_true", "check_data_parallel"]
