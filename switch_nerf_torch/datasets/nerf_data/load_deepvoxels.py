"""DeepVoxels scenes.

Port of ``switch_nerf_tpu/datasets/nerf_data/load_deepvoxels.py:15-77``:
per-view 4x4 pose text files (OpenCV convention, flipped into NeRF's
OpenGL one), intrinsics.txt (focal, principal point, barycentre, near
plane, scale, size), 512x512 images, and the train / validation / test
splits of one --shape, every --testskip-th view of the last two.
"""
from __future__ import annotations

import os

import numpy as np
from PIL import Image

__all__ = ["load_pose", "load_dv_data"]


def load_pose(path) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float32).reshape(4, 4)


def _focal(filepath, target_side_len: int) -> float:
    """intrinsics.txt's focal length rescaled to `target_side_len`."""
    with open(filepath) as f:
        f_ = list(map(float, f.readline().split()))[0]
        for _ in range(3):        # barycentre, near plane, scale
            f.readline()
        height = float(f.readline().split()[0])
    return np.float32(target_side_len / height * f_)


def _dir_files(d, ext):
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.endswith(ext)]


def _read_rgb(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def load_dv_data(scene="cube", basedir="/data/deepvoxels", testskip=8):
    """(imgs [N, 512, 512, 3], poses [N, 3, 4], render_poses (the test
    poses), [H, W, focal], [i_train, i_val, i_test])."""
    # OpenCV camera axes -> OpenGL (y and z flipped)
    transf = np.array([[1, 0, 0, 0], [0, -1, 0, 0],
                       [0, 0, -1, 0], [0, 0, 0, 1.0]], np.float32)

    h = w = 512
    focal = _focal(os.path.join(basedir, "train", scene, "intrinsics.txt"),
                   h)

    all_imgs, all_poses, counts = [], [], [0]
    for split, skip in (("train", 1), ("validation", testskip),
                        ("test", testskip)):
        base = os.path.join(basedir, split, scene)
        imgfiles = _dir_files(os.path.join(base, "rgb"), "png")[::skip]
        posefiles = _dir_files(os.path.join(base, "pose"), "txt")[::skip]
        imgs = np.stack([_read_rgb(f) for f in imgfiles])
        poses = np.stack([load_pose(f) for f in posefiles])
        poses = (poses @ transf)[:, :3, :4]
        all_imgs.append(imgs)
        all_poses.append(poses.astype(np.float32))
        counts.append(counts[-1] + imgs.shape[0])

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)
    render_poses = all_poses[2]
    return imgs, poses, render_poses, [h, w, focal], i_split
