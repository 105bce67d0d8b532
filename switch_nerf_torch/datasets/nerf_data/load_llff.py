"""LLFF forward-facing scenes (the poses_bounds.npy format).

Port of ``switch_nerf_tpu/datasets/nerf_data/load_llff.py:18-197``:
poses_bounds.npy ([N, 17]: a 3x5 pose with hwf and two depth bounds), the
images of ``images_<factor>`` when that directory exists, else of
``images`` shrunk by PIL's LANCZOS (the resampler JAX's loader uses, kept
apart from ``area_downsample`` on purpose), the rotation reorder, the
bd_factor rescale, recentring (``_poses_avg``, ``_recenter_poses``), the
spherified poses or the spiral render path, and the held-out view closest
to the average pose.
"""
from __future__ import annotations

import os

import numpy as np
from PIL import Image


def _normalize(x):
    return x / np.linalg.norm(x)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec1_avg = up
    vec0 = _normalize(np.cross(vec1_avg, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def _poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    c2w = np.concatenate([_viewmatrix(vec2, up, center), hwf], 1)
    return c2w


def _recenter_poses(poses):
    poses_ = poses.copy()
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = _poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    poses = np.concatenate([poses[:, :3, :4], bottom], -2)
    poses = np.linalg.inv(c2w) @ poses
    poses_[:, :3, :4] = poses[:, :3, :4]
    return poses_


def _render_path_spiral(c2w, up, rads, focal, zdelta, zrate, rots, n):
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n + 1)[:-1]:
        c = np.dot(c2w[:3, :4],
                   np.array([np.cos(theta), -np.sin(theta),
                             -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(np.concatenate([_viewmatrix(z, up, c), hwf], 1))
    return render_poses


def _spherify_poses(poses, bds):
    def p34_to_44(p):
        return np.concatenate([
            p, np.tile(np.reshape(np.eye(4)[-1, :], [1, 1, 4]),
                       [p.shape[0], 1, 1])], 1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    def min_line_dist(rays_o, rays_d):
        a_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
        b_i = -a_i @ rays_o
        return np.squeeze(-np.linalg.inv(
            (np.transpose(a_i, [0, 2, 1]) @ a_i).mean(0)) @ b_i.mean(0))

    pt_mindist = min_line_dist(rays_o, rays_d)
    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)

    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    pos = center
    c2w = np.stack([vec1, vec2, vec0, pos], 1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad ** 2 - zh ** 2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th),
                              radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = _normalize(camorigin)
        vec0 = _normalize(np.cross(vec2, up))
        vec1 = _normalize(np.cross(vec2, vec0))
        p = np.stack([vec0, vec1, vec2, camorigin], 1)
        new_poses.append(p)
    new_poses = np.stack(new_poses, 0)
    new_poses = np.concatenate([
        new_poses, np.broadcast_to(poses[0, :3, -1:],
                                   new_poses[:, :3, -1:].shape)], -1)
    poses_reset = np.concatenate([
        poses_reset[:, :3, :4],
        np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)], -1)
    return poses_reset, new_poses, bds


def _load_images(basedir, factor) -> np.ndarray:
    """The scene's images [N, H, W, 3] float32 in [0, 1], at 1/factor of
    the originals' size."""
    suffix = "" if factor in (None, 1) else f"_{factor}"
    imgdir = os.path.join(basedir, "images" + suffix)
    # the directory's existence decides, not the path's spelling
    pre_downscaled = bool(suffix) and os.path.exists(imgdir)
    if not pre_downscaled:
        imgdir = os.path.join(basedir, "images")
    names = [f for f in sorted(os.listdir(imgdir))
             if f.lower().endswith((".jpg", ".jpeg", ".png"))]
    imgs = []
    for f in names:
        with Image.open(os.path.join(imgdir, f)) as im:
            img = im.convert("RGB")
        if suffix and not pre_downscaled:
            img = img.resize((img.width // factor, img.height // factor),
                             Image.LANCZOS)
        imgs.append(np.asarray(img, np.float32) / 255.0)
    return np.stack(imgs, 0)


def load_llff_data(basedir, factor=8, recenter=True, bd_factor=0.75,
                   spherify=False, path_zflat=False):
    """(imgs [N, H, W, 3], poses [N, 3, 5], bds [N, 2], render_poses,
    i_test): the poses recentred and rescaled, hwf in their last column."""
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    imgs = _load_images(basedir, factor)
    if imgs.shape[0] != poses.shape[-1]:
        # a stray or missing image would misalign every (ray, rgb) pair
        raise ValueError(
            f"image/pose count mismatch: {imgs.shape[0]} images vs "
            f"{poses.shape[-1]} poses in {basedir}")
    sh = imgs[0].shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / (factor or 1)

    # correct rotation matrix ordering, move variable dim to axis 0
    poses = np.concatenate(
        [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc

    if recenter:
        poses = _recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = _spherify_poses(poses, bds)
    else:
        c2w = _poses_avg(poses)
        up = _normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        zdelta = close_depth * 0.2
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        c2w_path = c2w
        n_views, n_rots = 120, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            n_rots, n_views = 1, n_views // 2
        render_poses = _render_path_spiral(
            c2w_path, up, rads, focal, zdelta, zrate=0.5, rots=n_rots,
            n=n_views)
    render_poses = np.array(render_poses).astype(np.float32)

    c2w = _poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))

    return imgs, poses, bds, render_poses, i_test
