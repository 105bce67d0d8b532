"""Bungee-NeRF (Google Earth, multiscale) scenes.

Port of ``switch_nerf_tpu/datasets/nerf_data/load_bungee.py:20-97``: the
``poses_enu.json`` format (poses [-1, 3, 5] with hwf in the last column,
scene_scale, scene_origin, scale_split), images/ downsampled by `factor`,
and per-ray near/far from the earth sphere (or a flat plane) with the mip
radii from neighbouring ray directions. Images are decoded with PIL and
shrunk by ``area_downsample`` (the JAX package's OpenCV INTER_AREA).
"""
from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from switch_nerf_torch.datasets.nerf_data.ray_utils import area_downsample

EARTH_RADIUS = 6371011.0
BUILDING_HEIGHT = 250.0

_IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def _read_rgb(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _load_google_data(basedir, factor=None):
    imgdir = os.path.join(basedir, "images")
    names = [f for f in sorted(os.listdir(imgdir))
             if f.lower().endswith(_IMAGE_EXTS)]
    imgs = [_read_rgb(os.path.join(imgdir, f)) for f in names]
    sh = np.array(imgs[0].shape)
    imgs = np.stack([area_downsample(im, factor).astype(np.float32) / 255.0
                     for im in imgs], 0).astype(np.float32)

    with open(os.path.join(basedir, "poses_enu.json")) as fp:
        data = json.load(fp)
    poses = np.array(data["poses"])[:, :-2].reshape([-1, 3, 5])
    poses[:, :2, 4] = np.array(sh[:2] // factor).reshape([1, 2])
    poses[:, 2, 4] = poses[:, 2, 4] * 1.0 / factor
    return (imgs, poses, data["scene_scale"],
            np.array(data["scene_origin"]), data["scale_split"])


def load_bungee_multiscale_data(basedir, factor=3):
    """(images [N, H, W, 3] float32 in [0, 1], poses [N, 3, 5],
    scene_scale, scene_origin [3], scale_split)."""
    return _load_google_data(basedir, factor=factor)


def get_bungee_nearfar_radii(rays: np.ndarray, scene_scaling_factor: float,
                             scene_origin: np.ndarray, ray_nearfar: str):
    """rays [N, H, W, 6] -> (rays [N, H, W, 8], radii [N, H, W, 1])."""
    rays_o = rays[..., 0:3]
    rays_d = rays[..., 3:6]

    if ray_nearfar == "sphere":
        center = np.asarray(scene_origin, np.float32) * scene_scaling_factor
        r_earth = EARTH_RADIUS * scene_scaling_factor
        r_bldg = (EARTH_RADIUS + BUILDING_HEIGHT) * scene_scaling_factor

        oc = rays_o - center
        b = 2.0 * np.sum(oc * rays_d, axis=-1)
        d2 = np.sum(rays_d * rays_d, axis=-1)
        c2 = np.sum(oc * oc, axis=-1)

        def first_hit(radius):
            delta = b ** 2 - 4.0 * d2 * (c2 - radius ** 2)
            return (-b - np.sqrt(delta)) / (2.0 * d2)

        d_near = first_hit(r_bldg)
        d_far = first_hit(r_earth)
        dnorm = np.linalg.norm(rays_d, axis=-1)
        near = (np.abs(d_near) * dnorm)[..., None] * 0.9
        far = (np.abs(d_far) * dnorm)[..., None] * 1.1
    elif ray_nearfar == "flat":
        normal = np.array([0, 0, 1], np.float32) * scene_scaling_factor
        p0_far = np.array([0, 0, 0], np.float32) * scene_scaling_factor
        p0_near = np.array([0, 0, 250], np.float32) * scene_scaling_factor
        near = ((p0_near - rays_o * normal).sum(-1)
                / (rays_d * normal).sum(-1))
        far = ((p0_far - rays_o * normal).sum(-1)
               / (rays_d * normal).sum(-1))
        near = np.clip(near, 1e-6, None)[..., None]
        far = far[..., None]
    else:
        raise ValueError(f"unknown ray_nearfar {ray_nearfar!r}")

    new_rays = np.concatenate(
        [rays, near.astype(np.float32), far.astype(np.float32)], axis=-1)

    # mip radii: 2/sqrt(12) x the direction step between image rows
    dx = np.sqrt(np.sum((rays_d[:, :-1, :, :] - rays_d[:, 1:, :, :]) ** 2,
                        -1))
    dx = np.concatenate([dx, dx[:, -2:-1, :]], axis=1)
    radii = dx[..., None] * 2.0 / np.sqrt(12.0)
    return new_rays.astype(np.float32), radii.astype(np.float32)
