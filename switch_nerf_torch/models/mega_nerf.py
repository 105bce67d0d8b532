"""Mega-NeRF spatial-cluster model: centroid-routed submodules blended by
inverse distance inside a boundary margin.

Port of ``switch_nerf_tpu/models/mega_nerf.py:19-56``. Every submodule
runs on every point and the outputs are blended with the [S, N] weight
matrix: 1 / distance to each centroid within ``boundary_margin`` times the
nearest one's distance (0 beyond it), normalised; at margin 1 the argmin
one-hot (hard assignment). ``cluster_2d`` measures distance without the
first coordinate; ``xyz_real``: the first 3 columns route only and the
submodules see the rest. The submodules are named ``sub_modules_<i>`` as
flax names them, so ``bridge`` maps their leaves. No entry point builds
it, as in JAX.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

__all__ = ["MegaNeRF"]


class MegaNeRF(nn.Module):
    def __init__(self, sub_modules: Sequence[nn.Module], centroids,
                 boundary_margin: float = 1.15, xyz_real: bool = False,
                 cluster_2d: bool = False):
        super().__init__()
        if boundary_margin < 1:
            raise ValueError(f"boundary_margin {boundary_margin} < 1")
        for i, m in enumerate(sub_modules):
            self.add_module(f"sub_modules_{i}", m)
        self.n = len(sub_modules)
        self.register_buffer("centroids", torch.as_tensor(
            centroids, dtype=torch.float32), persistent=False)
        self.boundary_margin = boundary_margin
        self.xyz_real = xyz_real
        self.cluster_2d = cluster_2d

    def weights(self, x: torch.Tensor) -> torch.Tensor:
        """[S, N] blend weights of the points x[:, :3]."""
        start = 1 if self.cluster_2d else 0
        pts = x[:, start:3].float()
        d = torch.linalg.norm(
            pts[:, None, :] - self.centroids[None, :, start:], dim=-1)
        if self.boundary_margin > 1:
            inv = 1.0 / (d + 1e-8)
            min_d = torch.min(d, dim=1, keepdim=True).values
            inv = torch.where(d > self.boundary_margin * min_d,
                              torch.zeros_like(inv), inv)
            return inv / torch.sum(inv, dim=-1, keepdim=True)
        return torch.nn.functional.one_hot(
            torch.argmin(d, dim=1), self.n).to(d.dtype)

    def forward(self, x: torch.Tensor,
                sigma_noise: Optional[torch.Tensor] = None,
                train: bool = False, sigma_only: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        weights = self.weights(x)
        sub_in = x[:, 3:] if self.xyz_real else x
        out = None
        for i in range(self.n):
            res = getattr(self, f"sub_modules_{i}")(
                sub_in, sigma_noise=sigma_noise, train=train,
                sigma_only=sigma_only, generator=generator)
            if isinstance(res, dict):
                res = res["outputs"]
            w = weights[:, i:i + 1].to(res.dtype)
            out = res * w if out is None else out + res * w
        return out
