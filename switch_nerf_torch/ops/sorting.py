"""Sort-with-payloads: a stable sort of keys that carries payload tensors.

Port of ``switch_nerf_tpu/ops/sorting.py`` (forward only): one stable sort
plus one gather per payload, used by the renderer's coarse/fine merge.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["sort_with_payloads"]


def sort_with_payloads(keys: torch.Tensor,
                       *payloads: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Sort `keys` ascending along the last axis, carrying payloads.

    Returns (sorted_keys, *sorted_payloads). All operands share keys' shape.
    """
    sorted_keys, perm = torch.sort(keys, dim=-1, stable=True)
    return (sorted_keys,) + tuple(torch.gather(p, -1, perm) for p in payloads)
