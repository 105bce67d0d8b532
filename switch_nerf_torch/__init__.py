"""PyTorch + CUDA port of switch_nerf_tpu for NVIDIA Hopper (H100).

The port runs beside the JAX package, which stays the reference. It covers
the eval render path of the Mega-NeRF/Switch-NeRF configs
(`trainer.make_eval_step`) and their training step
(`trainer.make_train_step`): routing, padded capacity dispatch with its
gradients, the MoE expert chain (hand-written CUDA kernels on the card,
forward and backward), the dense background NeRF, the coarse/fine volume
renderer, and Adam with the exponential learning rate. Above them
``runner.Runner`` trains a scene (``train.py``: rays from the chunked
filesystem or the in-memory dataset, ``datasets/``; interval and SIGTERM
checkpoints in the JAX package's format, ``checkpoints.py``, from which a
run resumes exactly) and serves it (``eval_image.py``, ``eval.py``: renders
every val image and scores it, ``metrics.py``, ``lpips_torch.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper takes its plain PyTorch version. Under
``torchrun`` they run data-parallel, one process per card (``parallel/``):
``python -m torch.distributed.run --nproc_per_node=8 -m
switch_nerf_torch.train ...``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``cuda`` (as ``cuda:<current>``) by default, and ``cuda:LOCAL_RANK``
    in a process group of more than one process; raise rather than fall
    back to the CPU. An explicit ``device`` always wins."""
    if device is None:
        from switch_nerf_torch.parallel import host
        if host.world_size() > 1:
            return _local_card(host.local_rank())
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "switch_nerf_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _local_card(local: int) -> torch.device:
    """The card of this process in a group: cuda:LOCAL_RANK, made the
    current device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a multi-process run of switch_nerf_torch takes one CUDA device "
            "per process and none is available; pass device='cpu'")
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"LOCAL_RANK {local} but {torch.cuda.device_count()} CUDA "
            "device(s): start at most one process per card")
    torch.cuda.set_device(local)
    return torch.device("cuda", local)
