"""``NeRFDataset``: the classic-NeRF data container and its train, val and
test views.

Port of ``switch_nerf_tpu/datasets/nerf_data/nerf_loader.py:26-246``:

  * llff: every --llffhold-th image held out for val and test, NDC rays
    unless --no_ndc (then near/far from the depth bounds);
  * blender: white_bkgd alpha compositing, near 2 / far 6;
  * LINEMOD: its own K and near/far; deepvoxels: near/far on the
    hemisphere of the cameras;
  * bungee: every --llffhold-th image held out, per-ray near/far from the
    earth sphere and mip radii [N, H, W, 1].

The whole set is shrunk by --scale_factor with ``area_downsample`` (the
JAX package's OpenCV INTER_AREA), the intrinsics and the NDC focal with
it, as the JAX package does. Rays are precomputed per image as
[N, H, W, 8] (origin, direction, near, far; unit directions unless NDC)
and the train split flattened to rays.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from switch_nerf_torch.datasets.dataset_utils import EpochPermutationSampler
from switch_nerf_torch.datasets.nerf_data.load_blender import \
    load_blender_data
from switch_nerf_torch.datasets.nerf_data.load_bungee import (
    get_bungee_nearfar_radii, load_bungee_multiscale_data)
from switch_nerf_torch.datasets.nerf_data.load_deepvoxels import load_dv_data
from switch_nerf_torch.datasets.nerf_data.load_LINEMOD import \
    load_LINEMOD_data
from switch_nerf_torch.datasets.nerf_data.load_llff import load_llff_data
from switch_nerf_torch.datasets.nerf_data.ray_utils import (area_downsample,
                                                            get_rays,
                                                            ndc_rays)


def _holdout(n: int, hold: int):
    i_test = np.arange(n)[::hold]
    return i_test, np.array([i for i in np.arange(n) if i not in i_test])


def _composite(images: np.ndarray, white_bkgd: bool) -> np.ndarray:
    """RGBA -> RGB over white (--white_bkgd) or dropping alpha."""
    if white_bkgd:
        return images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
    return images[..., :3]


class NeRFDataset:
    def __init__(self, args) -> None:
        self.K = None
        self.radii = None
        self.scene_origin = None
        self.scale_split = None
        self.scene_scaling_factor = None
        kind = args.dataset_type

        if kind == "llff":
            images, poses, bds, render_poses, i_avg = load_llff_data(
                args.datadir, args.factor, recenter=True, bd_factor=0.75,
                spherify=args.spherify)
            hwf = poses[0, :3, -1]
            poses = poses[:, :3, :4]
            if args.llffhold > 0:
                i_test, i_train = _holdout(images.shape[0], args.llffhold)
            else:           # the view closest to the average pose
                i_test = [i_avg]
                i_train = np.array([i for i in range(images.shape[0])
                                    if i != i_avg])
            i_val = i_test
            if args.no_ndc:
                near = float(np.min(bds)) * 0.9
                far = float(np.max(bds)) * 1.0
            else:
                near, far = 0.0, 1.0
        elif kind == "blender":
            images, poses, render_poses, hwf, i_split = load_blender_data(
                args.datadir, args.half_res, args.testskip)
            i_train, i_val, i_test = i_split
            near, far = 2.0, 6.0
            images = _composite(images, args.white_bkgd)
        elif kind == "LINEMOD":
            (images, poses, render_poses, hwf, k, i_split, near,
             far) = load_LINEMOD_data(args.datadir, args.half_res,
                                      args.testskip)
            self.K = np.asarray(k, np.float32)
            i_train, i_val, i_test = i_split
            images = _composite(images, args.white_bkgd)
        elif kind == "deepvoxels":
            images, poses, render_poses, hwf, i_split = load_dv_data(
                scene=getattr(args, "shape", "cube"), basedir=args.datadir,
                testskip=args.testskip)
            i_train, i_val, i_test = i_split
            hemi_r = float(np.mean(np.linalg.norm(poses[:, :3, -1],
                                                  axis=-1)))
            near, far = hemi_r - 1.0, hemi_r + 1.0
            poses = poses[:, :3, :4]
        elif kind == "bungee":
            (images, poses, scene_scaling_factor, scene_origin,
             scale_split) = load_bungee_multiscale_data(args.datadir,
                                                        args.factor)
            self.scene_origin = scene_origin
            self.scale_split = scale_split
            self.scene_scaling_factor = scene_scaling_factor
            i_test, i_train = _holdout(images.shape[0], args.llffhold)
            i_val = i_test
            hwf = poses[0, :3, -1]
            poses = poses[:, :3, :4]
            render_poses = poses
            near, far = 0.0, 1.0   # unused: bungee rays carry their own
        else:
            raise NotImplementedError(
                f"dataset type {kind!r} not supported")

        self.poses = np.asarray(poses, np.float32)
        self.render_poses = np.asarray(render_poses, np.float32)
        self.i_train, self.i_val, self.i_test = i_train, i_val, i_test
        self.near, self.far = near, far

        h, w, focal = hwf
        h, w = int(h), int(w)
        if self.K is None:
            self.K = np.array([[focal, 0, 0.5 * w],
                               [0, focal, 0.5 * h],
                               [0, 0, 1]], np.float32)
        self.H, self.W = h, w
        self.hwf = [h, w, focal]

        if getattr(args, "scale_factor", 1) > 1:
            # intrinsics and the NDC focal scaled with the images, as the
            # JAX package does
            sf = args.scale_factor
            if self.H % sf or self.W % sf:
                raise ValueError(f"{self.W}x{self.H} images do not divide by "
                                 f"--scale_factor {sf}")
            self.H, self.W = self.H // sf, self.W // sf
            self.hwf = [self.H, self.W, focal / sf]
            self.K[:2, :] = self.K[:2, :] / sf
            images = np.stack([area_downsample(img, sf) for img in images])
        self.images = np.asarray(images, np.float32)

        rays = []
        for p in self.poses:
            rays_o, rays_d = get_rays(self.H, self.W, self.K, p)
            if not args.no_ndc:
                rays_o, rays_d = ndc_rays(self.H, self.W, self.hwf[2], 1.0,
                                          rays_o, rays_d)
            else:
                rays_d = rays_d / np.linalg.norm(rays_d, axis=-1,
                                                 keepdims=True)
            rays.append(np.concatenate([rays_o, rays_d], -1))
        rays = np.stack(rays, 0)                               # [N, H, W, 6]

        if kind == "bungee":
            rays, radii = get_bungee_nearfar_radii(
                rays, scene_scaling_factor=self.scene_scaling_factor,
                scene_origin=self.scene_origin,
                ray_nearfar=args.bungee_ray_nearfar)
            self.radii = radii.astype(np.float32)              # [N, H, W, 1]
        else:
            ones = np.ones_like(rays[..., :1])
            rays = np.concatenate([rays, self.near * ones, self.far * ones],
                                  -1)
        self.rays = rays.astype(np.float32)                    # [N, H, W, 8]
        self.rgbs = self.images

        self.rays_train = self.rays[i_train].reshape(-1, 8)
        self.rgbs_train = self.rgbs[i_train].reshape(-1, 3)
        self.rays_val, self.rgbs_val = self.rays[i_val], self.rgbs[i_val]
        self.rays_test, self.rgbs_test = self.rays[i_test], self.rgbs[i_test]
        if self.radii is not None:
            self.radii_train = self.radii[i_train].reshape(-1, 1)
            self.radii_val = self.radii[i_val]
            self.radii_test = self.radii[i_test]
        self.args = args

    @property
    def is_bungee(self) -> bool:
        return self.args.dataset_type == "bungee"


class NeRFDatasetTrain:
    """Flat per-ray view over the train split."""

    def __init__(self, dataset: NeRFDataset, seed: int = 42):
        self.dataset = dataset
        self._seed = seed
        self._sampler = None

    def __len__(self) -> int:
        return self.dataset.rays_train.shape[0]

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        d = self.dataset
        sample = {"rays": d.rays_train[idx], "rgbs": d.rgbs_train[idx]}
        if d.is_bungee:
            sample["radii"] = d.radii_train[idx]
        return sample

    def get_batch(self, global_batch: int, batch_size: int
                  ) -> Dict[str, np.ndarray]:
        """Batch `global_batch` of the per-epoch permutation (keyed by the
        seed and the epoch): a resumed run replays the same batches."""
        if self._sampler is None:
            self._sampler = EpochPermutationSampler(len(self), self._seed)
        return self[self._sampler.batch_indices(global_batch, batch_size)]


class _ImageSplit:
    """Per-image view over the val or test split; img_i is the image's
    index in the whole set."""

    def __init__(self, dataset: NeRFDataset, split: str):
        self.dataset = dataset
        self._split = split

    def __len__(self) -> int:
        return len(getattr(self.dataset, f"i_{self._split}"))

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        d, sp = self.dataset, self._split
        sample = {"rays": getattr(d, f"rays_{sp}")[idx],
                  "rgbs": getattr(d, f"rgbs_{sp}")[idx],
                  "img_i": getattr(d, f"i_{sp}")[idx]}
        if d.is_bungee:
            sample["radii"] = getattr(d, f"radii_{sp}")[idx]
        return sample


class NeRFDatasetVal(_ImageSplit):
    def __init__(self, dataset: NeRFDataset):
        super().__init__(dataset, "val")


class NeRFDatasetTest(_ImageSplit):
    def __init__(self, dataset: NeRFDataset):
        super().__init__(dataset, "test")
