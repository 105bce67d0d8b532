"""Blender-synthetic scenes (lego and the rest of NeRF-synthetic).

Port of ``switch_nerf_tpu/datasets/nerf_data/load_blender.py:37-88``: the
``transforms_{train,val,test}.json`` format, every --testskip-th frame of
val and test, rgba float images in [0, 1], focal from camera_angle_x, the
40-pose render path on a radius-4 circle (``pose_spherical``), and the
half_res branch, which halves the images with ``area_downsample`` where
the JAX package uses OpenCV's float INTER_AREA.
"""
from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from switch_nerf_torch.datasets.nerf_data.ray_utils import area_downsample

__all__ = ["pose_spherical", "load_blender_data"]


def _trans_t(t):
    return np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]],
                    np.float32)


def _rot_phi(phi):
    return np.array([[1, 0, 0, 0],
                     [0, np.cos(phi), -np.sin(phi), 0],
                     [0, np.sin(phi), np.cos(phi), 0],
                     [0, 0, 0, 1]], np.float32)


def _rot_theta(th):
    return np.array([[np.cos(th), 0, -np.sin(th), 0],
                     [0, 1, 0, 0],
                     [np.sin(th), 0, np.cos(th), 0],
                     [0, 0, 0, 1]], np.float32)


def pose_spherical(theta, phi, radius) -> np.ndarray:
    """The c2w [4, 4] of a camera at `radius` on the sphere, azimuth
    `theta` and elevation `phi` in degrees, looking at the origin."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                   np.float32) @ c2w
    return c2w


def render_ring() -> np.ndarray:
    """The 40 render poses: azimuths -180..171 degrees, elevation -30,
    radius 4."""
    return np.stack([pose_spherical(angle, -30.0, 4.0)
                     for angle in np.linspace(-180, 180, 41)[:-1]])


def load_blender_data(basedir, half_res: bool = False, testskip: int = 1):
    """(imgs [N, H, W, 4] float32, poses [N, 4, 4], render_poses [40, 4, 4],
    [H, W, focal], [i_train, i_val, i_test])."""
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if s == "train" or testskip == 0 else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            with Image.open(fname) as im:
                imgs.append(np.asarray(im.convert("RGBA"), np.float32)
                            / 255.0)
            poses.append(np.array(frame["transform_matrix"], np.float32))
        all_imgs.append(np.stack(imgs))
        all_poses.append(np.stack(poses))
        counts.append(counts[-1] + len(imgs))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    h, w = imgs[0].shape[:2]
    camera_angle_x = float(metas["train"]["camera_angle_x"])
    focal = 0.5 * w / np.tan(0.5 * camera_angle_x)
    render_poses = render_ring()

    if half_res:
        # float area resample (a uint8 round trip would lose sub-1/255
        # precision in rgb and alpha); the sides must be even
        h, w = h // 2, w // 2
        focal = focal / 2.0
        imgs = np.stack([area_downsample(img, 2) for img in imgs])

    return imgs, poses, render_poses, [h, w, focal], i_split
