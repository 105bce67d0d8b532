"""Classic-NeRF data for ``train_nerf_moe`` / ``eval_nerf_moe``: the Bungee
(Google Earth, multiscale) scenes, all in host memory, rays precomputed per
image as [N, H, W, 8] with mip radii [N, H, W, 1].

Port of ``switch_nerf_tpu/datasets/nerf_data/``; the llff, blender, LINEMOD
and deepvoxels loaders wait for ROADMAP Queue A item 7.
"""
from switch_nerf_torch.datasets.nerf_data.nerf_loader import (
    NeRFDataset, NeRFDatasetTest, NeRFDatasetTrain, NeRFDatasetVal)

__all__ = ["NeRFDataset", "NeRFDatasetTrain", "NeRFDatasetVal",
           "NeRFDatasetTest"]
