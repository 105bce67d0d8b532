"""Classic-NeRF data for ``train_nerf_moe`` / ``eval_nerf_moe``: the llff,
blender, LINEMOD, deepvoxels and Bungee (Google Earth, multiscale) scenes,
all in host memory, rays precomputed per image as [N, H, W, 8] (with mip
radii [N, H, W, 1] for Bungee), and the gigapixel image loader.

Port of ``switch_nerf_tpu/datasets/nerf_data/``.
"""
from switch_nerf_torch.datasets.nerf_data.nerf_loader import (
    NeRFDataset, NeRFDatasetTest, NeRFDatasetTrain, NeRFDatasetVal)

__all__ = ["NeRFDataset", "NeRFDatasetTrain", "NeRFDatasetVal",
           "NeRFDatasetTest"]
