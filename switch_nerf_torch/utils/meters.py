"""Running-mean meters for scalar metric dicts, and the JSON exchange of a
data-parallel run.

Port of ``switch_nerf_tpu/utils/meters.py``: ``DictAverageMeter`` and
``allgather_json``. In a process group the means run over every process,
merged by key name, so a rank that scored no image (more ranks than val
images) holds no keys and changes nothing.
"""
from __future__ import annotations

import json
from typing import Dict, List

from switch_nerf_torch.parallel import host


def allgather_json(obj: dict) -> List[dict]:
    """Every process's JSON-serialisable dict, by rank (one process:
    ``[obj]``). The dicts travel as JSON text, keys in their order, so
    every process reads the same values whatever their Python types
    were."""
    if host.world_size() == 1:
        return [obj]
    texts = host.all_gather_object(json.dumps(obj))
    return [json.loads(t) for t in texts]


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
        """Per-key means over every process's updates: sums and counts
        merged by key name, never by position (the plain mean in one
        process). Every process of a group must call it."""
        if host.world_size() == 1:
            return self.mean()
        sums: Dict[str, float] = {}
        counts: Dict[str, float] = {}
        for d in allgather_json({"s": self.sums, "c": self.counts}):
            for k, v in d["s"].items():
                sums[k] = sums.get(k, 0.0) + float(v)
            for k, v in d["c"].items():
                counts[k] = counts.get(k, 0.0) + float(v)
        return {k: sums[k] / max(counts.get(k, 0.0), 1.0) for k in sums}
