"""The process group of a data-parallel run: one process per card.

Port of ``switch_nerf_tpu/parallel/host.py:21-69`` and of the JAX
runner's host helpers (``_broadcast_str``, ``_global_any``,
``_host_barrier``). JAX runs one program per host over its mesh; the port
runs one process per card under ``torchrun``, which hands every process
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``.

Collectives on device tensors are only ``all_reduce`` and ``broadcast``:
the two that ``gloo`` runs on CUDA tensors, so the same code runs on NCCL
(one process per card), on gloo over the CPU (the tests) and on gloo with
several processes on one card (``chip_smoke.py``; NCCL refuses two ranks
on one card). Host data (JSON, strings, generator states) goes through the
object collectives. With no group, or a group of one, every helper is the
one-process answer.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "destroy", "rank", "world_size", "local_rank",
           "is_main", "barrier", "broadcast_str", "broadcast_tensors_",
           "all_gather_object", "all_true", "any_true"]


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(device=None, *, world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout: Optional[datetime.timedelta] = None) -> bool:
    """Join the process group torchrun describes; True when this call
    created it (the caller then destroys it, ``destroy``).

    A group the caller already initialised is used as it is. With
    ``WORLD_SIZE`` unset or 1 and no explicit ``world_size``, nothing is
    initialised: one process. Otherwise ``init_process_group`` over
    ``env://`` with ``nccl`` for a CUDA device (``device`` None means the
    card, as the entry points' default) and ``gloo`` for the CPU; the card
    is ``cuda:LOCAL_RANK``. A failure raises: a silent fallback would train
    N independent copies.
    """
    if _initialized():
        return False
    env_world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world_size is None and env_world <= 1:
        return False
    world = env_world if world_size is None else int(world_size)
    rnk = int(os.environ.get("RANK", "0")) if rank is None else int(rank)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        from switch_nerf_torch import _local_card
        _local_card(local_rank())
        backend = "nccl"
    else:
        backend = "gloo"
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rnk, **kwargs)
    return True


def destroy() -> None:
    if _initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if _initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def is_main() -> bool:
    return rank() == 0


def _flag_device() -> torch.device:
    """Where a host flag travels: the current card under NCCL, else the
    CPU."""
    if _initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str = "") -> None:
    """Every process waits here (``name`` says where, for a reader of a
    hang's stack dump)."""
    if world_size() > 1:
        dist.barrier()


def broadcast_tensors_(tensors: List[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` with rank ``src``'s, in place: one broadcast
    of a flat buffer per dtype."""
    if world_size() == 1:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, src=src)
        lo = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[lo:lo + t.numel()].view_as(t))
                lo += t.numel()


def all_gather_object(obj: Any) -> List[Any]:
    """Every process's ``obj``, by rank (one process: ``[obj]``)."""
    if world_size() == 1:
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_str(s: str) -> str:
    """Rank 0's string on every process."""
    if world_size() == 1:
        return s
    box = [s]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _reduce_flag(flag: bool, op) -> bool:
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=_flag_device())
    dist.all_reduce(t, op=op)
    return bool(t.item() > 0.5)


def all_true(flag: bool) -> bool:
    """Global AND of a per-process flag."""
    return _reduce_flag(flag, dist.ReduceOp.MIN)


def any_true(flag: bool) -> bool:
    """Global OR of a per-process flag."""
    return _reduce_flag(flag, dist.ReduceOp.MAX)
