"""What the port takes of the JAX package's ('data', 'expert') mesh.

The port runs pure data parallelism (the reference's default): every rank
holds the whole model, routes its rays on the global batch's model
chunks (``chunks.py``), and the gradients are averaged over the ranks. So ``--mesh_shape D`` or ``D 1`` with D the number of
processes is accepted; expert parallelism (an 'expert' axis longer than 1,
``--expert_parallel``), expert-weight parallelism and ZeRO-1 optimizer
sharding wait for ROADMAP Queue A item 8.
"""
from __future__ import annotations

from typing import Tuple


def _waits(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} waits for the port's expert parallelism (ROADMAP Queue A "
        "item 8); the port runs pure data parallelism")


def check_data_parallel(hparams, world: int) -> Tuple[int, int]:
    """Refuse the flags of the parallelism the port does not run; returns
    the (data, expert) mesh shape, (world, 1)."""
    if not getattr(hparams, "no_expert_parallel", True):
        raise _waits("--expert_parallel")
    if getattr(hparams, "expert_weight_parallel", False):
        raise _waits("--expert_weight_parallel")
    if getattr(hparams, "shard_optimizer_states", False):
        raise _waits("--shard_optimizer_states (ZeRO-1)")
    shape = getattr(hparams, "mesh_shape", None)
    if shape is None:
        return world, 1
    shape = tuple(int(x) for x in shape)
    if len(shape) not in (1, 2):
        raise ValueError(f"--mesh_shape {list(shape)}: give D or D E")
    d, e = shape[0], (shape[1] if len(shape) == 2 else 1)
    if e > 1:
        raise _waits(f"--mesh_shape {d} {e} (an expert axis of {e})")
    if d != world:
        raise ValueError(f"--mesh_shape {list(shape)}: the data axis must be"
                         f" the number of processes, {world}")
    return d, e
