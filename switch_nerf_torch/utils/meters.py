"""Running-mean meters for scalar metric dicts.

Port of ``DictAverageMeter`` (``switch_nerf_tpu/utils/meters.py:46-80``).
One process only: the cross-process mean (and the JSON allgather behind
it) waits for the port's multi-process support (ROADMAP Queue A item 8).
"""
from __future__ import annotations

from typing import Dict

import torch


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class DictAverageMeter:
    def __init__(self):
        self.sums: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def update(self, values: Dict[str, float], n: int = 1) -> None:
        for k, v in values.items():
            v = float(v)
            self.sums[k] = self.sums.get(k, 0.0) + v * n
            self.counts[k] = self.counts.get(k, 0) + n

    def mean(self) -> Dict[str, float]:
        return {k: self.sums[k] / max(self.counts[k], 1) for k in self.sums}

    def reset(self) -> None:
        self.sums.clear()
        self.counts.clear()

    def mean_across_processes(self) -> Dict[str, float]:
        """Per-key means over all processes: the plain mean in one process.
        A torch.distributed group of more than one process raises."""
        if _world_size() > 1:
            raise NotImplementedError(
                "metric means across processes wait for the port's "
                "multi-process support (ROADMAP Queue A item 8)")
        return self.mean()
