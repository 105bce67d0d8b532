"""``NeRFDataset``: the classic-NeRF data container and its train, val and
test views.

Port of ``switch_nerf_tpu/datasets/nerf_data/nerf_loader.py:26-246`` for
the Bungee scenes: every --llffhold-th image is held out for val and test,
the whole set is shrunk by --scale_factor (the intrinsics with it), rays
are precomputed per image as [N, H, W, 8] (unit directions, per-ray
near/far) with mip radii [N, H, W, 1], the train split flattened to rays.
The llff, blender, LINEMOD and deepvoxels branches wait for ROADMAP Queue A
item 7.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from switch_nerf_torch.datasets.dataset_utils import EpochPermutationSampler
from switch_nerf_torch.datasets.nerf_data.load_bungee import (
    get_bungee_nearfar_radii, load_bungee_multiscale_data)
from switch_nerf_torch.datasets.nerf_data.ray_utils import (area_downsample,
                                                            get_rays)


class NeRFDataset:
    def __init__(self, args) -> None:
        if args.dataset_type != "bungee":
            raise NotImplementedError(
                f"the {args.dataset_type!r} classic-NeRF loader waits for the "
                "port's other workloads (ROADMAP Queue A item 7); the port "
                "loads bungee scenes")
        (images, poses, scene_scaling_factor, scene_origin,
         scale_split) = load_bungee_multiscale_data(args.datadir, args.factor)
        self.scene_origin = scene_origin
        self.scale_split = scale_split
        self.scene_scaling_factor = scene_scaling_factor
        i_test = np.arange(images.shape[0])[::args.llffhold]
        i_val = i_test
        i_train = np.array([i for i in np.arange(int(images.shape[0]))
                            if i not in i_test])
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        near, far = 0.0, 1.0     # unused: bungee rays carry their own bounds

        self.poses = np.asarray(poses, np.float32)
        self.render_poses = self.poses
        self.i_train, self.i_val, self.i_test = i_train, i_val, i_test
        self.near, self.far = near, far

        h, w, focal = hwf
        h, w = int(h), int(w)
        self.K = np.array([[focal, 0, 0.5 * w],
                           [0, focal, 0.5 * h],
                           [0, 0, 1]], np.float32)
        self.H, self.W = h, w
        self.hwf = [h, w, focal]

        if getattr(args, "scale_factor", 1) > 1:
            # intrinsics scaled with the images, as the JAX package does
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
            rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
            rays.append(np.concatenate([rays_o, rays_d], -1))
        rays, radii = get_bungee_nearfar_radii(
            np.stack(rays, 0), scene_scaling_factor=self.scene_scaling_factor,
            scene_origin=self.scene_origin,
            ray_nearfar=args.bungee_ray_nearfar)
        self.radii = radii.astype(np.float32)                  # [N, H, W, 1]
        self.rays = rays.astype(np.float32)                    # [N, H, W, 8]
        self.rgbs = self.images

        self.rays_train = self.rays[i_train].reshape(-1, 8)
        self.rgbs_train = self.rgbs[i_train].reshape(-1, 3)
        self.radii_train = self.radii[i_train].reshape(-1, 1)
        self.rays_val, self.rgbs_val = self.rays[i_val], self.rgbs[i_val]
        self.rays_test, self.rgbs_test = self.rays[i_test], self.rgbs[i_test]
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
        return {"rays": self.dataset.rays_train[idx],
                "rgbs": self.dataset.rgbs_train[idx],
                "radii": self.dataset.radii_train[idx]}

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
        return {"rays": getattr(d, f"rays_{sp}")[idx],
                "rgbs": getattr(d, f"rgbs_{sp}")[idx],
                "img_i": getattr(d, f"i_{sp}")[idx],
                "radii": getattr(d, f"radii_{sp}")[idx]}


class NeRFDatasetVal(_ImageSplit):
    def __init__(self, dataset: NeRFDataset):
        super().__init__(dataset, "val")


class NeRFDatasetTest(_ImageSplit):
    def __init__(self, dataset: NeRFDataset):
        super().__init__(dataset, "test")
