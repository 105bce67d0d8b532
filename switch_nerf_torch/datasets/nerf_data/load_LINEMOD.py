"""LINEMOD scenes (6-DoF pose-estimation scenes adapted for NeRF).

Port of ``switch_nerf_tpu/datasets/nerf_data/load_LINEMOD.py:24-91``: the
frames of ``transforms_{split}.json`` carry their file_path and
intrinsic_matrix (focal = K[0][0], read from the last split's first
frame; there is no camera_angle_x), near/far are floor(min)/ceil(max) of
the train and test splits', the render path is the 40-pose ring, and
palette PNGs are expanded as imageio expands them. The half_res branch
keeps the JAX package's two deviations (the source channel count kept, K
rescaled with focal) and halves the images with ``area_downsample`` where
the JAX package uses OpenCV's INTER_AREA.
"""
from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from switch_nerf_torch.datasets.nerf_data.load_blender import render_ring
from switch_nerf_torch.datasets.nerf_data.ray_utils import area_downsample

__all__ = ["load_LINEMOD_data"]


def _read(path: str) -> np.ndarray:
    with Image.open(path) as img:
        if img.mode == "P":
            # imageio expands palette PNGs; bare PIL gives 2-D indices
            img = img.convert("RGBA" if "transparency" in img.info
                              else "RGB")
        return np.asarray(img)


def load_LINEMOD_data(basedir, half_res: bool = False, testskip: int = 1):
    """(imgs [N, H, W, C] float32, poses [N, 4, 4], render_poses, [H, W,
    focal], K, [i_train, i_val, i_test], near, far)."""
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    meta = None
    for s in splits:
        meta = metas[s]
        skip = 1 if s == "train" or testskip == 0 else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            # an absolute file_path (the real dataset's) stays as it is
            imgs.append(_read(os.path.join(basedir, frame["file_path"])))
            poses.append(np.array(frame["transform_matrix"]))
        all_imgs.append((np.array(imgs) / 255.0).astype(np.float32))
        all_poses.append(np.array(poses).astype(np.float32))
        counts.append(counts[-1] + len(imgs))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    h, w = imgs[0].shape[:2]
    focal = float(meta["frames"][0]["intrinsic_matrix"][0][0])
    k = meta["frames"][0]["intrinsic_matrix"]
    render_poses = render_ring()

    if half_res:
        h, w = h // 2, w // 2
        focal = focal / 2.0
        k = np.array(k, np.float64)
        k[:2, :] = k[:2, :] / 2.0
        imgs = np.stack([area_downsample(img, 2).reshape(h, w, -1)
                         for img in imgs]).astype(np.float64)

    near = np.floor(min(metas["train"]["near"], metas["test"]["near"]))
    far = np.ceil(max(metas["train"]["far"], metas["test"]["far"]))
    return imgs, poses, render_poses, [h, w, focal], k, i_split, near, far
