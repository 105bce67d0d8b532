"""All-in-RAM ray dataset for small scenes.

Port of ``switch_nerf_tpu/datasets/memory_dataset.py``: every train image's
kept pixels (``get_rgb_index_mask``) with their rays (``ray_utils``, numpy)
in host memory; ``get_batch`` draws batches by epoch permutation keyed by
the global batch counter, so a resumed run replays the same batches.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from switch_nerf_torch.datasets.dataset_utils import (EpochPermutationSampler,
                                                      get_rgb_index_mask)
from switch_nerf_torch.datasets.image_metadata import ImageMetadata
from switch_nerf_torch.datasets.ray_utils import compute_image_rays


class MemoryDataset:
    def __init__(self, metadata_items: List[ImageMetadata], near: float,
                 far: float, ray_altitude_range: Optional[Sequence[float]],
                 center_pixels: bool, seed: int = 42):
        # a seeded generator (not OS entropy): the val-half resampling is
        # reproducible under --random_seed
        rng = np.random.default_rng(seed)
        rgbs, rays, indices = [], [], []
        for item in metadata_items:
            image_data = get_rgb_index_mask(item, rng)
            if image_data is None:
                continue
            image_rgbs, image_indices, keep_mask = image_data
            image_rays = compute_image_rays(
                item.c2w, item.W, item.H, item.intrinsics, center_pixels,
                near, far, ray_altitude_range)
            if keep_mask is not None:
                image_rays = image_rays[keep_mask]
            rgbs.append(image_rgbs.astype(np.float32) / 255.0)
            rays.append(image_rays)
            indices.append(image_indices)

        self._rgbs = np.concatenate(rgbs)
        self._rays = np.concatenate(rays)
        self._image_indices = np.concatenate(indices)
        self._sampler = EpochPermutationSampler(len(self), seed)

    def __len__(self) -> int:
        return self._rgbs.shape[0]

    def get_batch(self, global_batch: int, batch_size: int
                  ) -> Dict[str, np.ndarray]:
        """Batch number ``global_batch`` of the epoch permutations."""
        idx = self._sampler.batch_indices(global_batch, batch_size)
        return {
            "rgbs": self._rgbs[idx],
            "rays": self._rays[idx],
            "image_indices": self._image_indices[idx].astype(np.float32),
        }
