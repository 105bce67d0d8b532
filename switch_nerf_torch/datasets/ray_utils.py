"""Mega-NeRF ray generation (host-side numpy).

Port of ``switch_nerf_tpu/datasets/ray_utils.py``, numpy path only. The
JAX package's multithreaded C++ ray generator (``native/raygen.cc``) is
not ported: it is host code and no TPU kernel, it speeds up work that runs
beside the card (the chunk prefetch thread, the val-image rays), and the
JAX package's own numpy fallback gives the same rays within 1e-5.
  * get_ray_directions: +0.5 center-pixel offset, (i-cx)/fx, -(j-cy)/fy, -1,
    normalized.
  * get_rays / get_rays_batch: rotate to world by c2w, append near/far
    columns; rays are 8 floats [o(3), d(3), near, far].
  * altitude-plane truncation: near bound pushed to the high-altitude plane
    intersection, far bound pulled to the low plane (drb convention: +x is
    down, altitudes negative).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def get_ray_directions(w: int, h: int, fx: float, fy: float, cx: float,
                       cy: float, center_pixels: bool) -> np.ndarray:
    """[H, W, 3] unit directions in the camera frame."""
    i, j = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="xy")
    if center_pixels:
        i = i + 0.5
        j = j + 0.5
    directions = np.stack([(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)],
                          axis=-1)
    directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
    return directions


def _truncate_with_plane_intersection(rays_o: np.ndarray, rays_d: np.ndarray,
                                      altitude: float,
                                      default_bounds: np.ndarray) -> None:
    """In-place: replace bounds with distance to the x=altitude plane for
    rays that start above it and head down (+x)."""
    starts_before = rays_o[..., 0] < altitude
    goes_down = rays_d[..., 0] > 0
    boundable = starts_before & goes_down
    if not boundable.any():
        return
    o = rays_o[boundable]
    d = rays_d[boundable]
    # distance along the ray to the plane x == altitude
    si = (altitude - o[:, 0]) / d[:, 0]
    dist = np.abs(si) * np.linalg.norm(d, axis=-1)
    default_bounds[boundable] = dist[:, None]


def _get_rays_inner(rays_o: np.ndarray, rays_d: np.ndarray, near: float,
                    far: float,
                    ray_altitude_range: Optional[Sequence[float]]) -> np.ndarray:
    near_bounds = np.full((*rays_o.shape[:-1], 1), near, np.float32)
    far_bounds = np.full((*rays_o.shape[:-1], 1), far, np.float32)
    if ray_altitude_range is not None:
        _truncate_with_plane_intersection(rays_o, rays_d,
                                          ray_altitude_range[0], near_bounds)
        near_bounds = np.clip(near_bounds, a_min=near, a_max=None)
        _truncate_with_plane_intersection(rays_o, rays_d,
                                          ray_altitude_range[1], far_bounds)
        far_bounds = np.clip(far_bounds, a_min=None, a_max=far)
        far_bounds = np.maximum(near_bounds, far_bounds)
    return np.concatenate([rays_o, rays_d, near_bounds, far_bounds],
                          axis=-1).astype(np.float32)


def get_rays(directions: np.ndarray, c2w: np.ndarray, near: float, far: float,
             ray_altitude_range: Optional[Sequence[float]] = None) -> np.ndarray:
    """directions [..., 3], c2w [3, 4] -> rays [..., 8]."""
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape).copy()
    return _get_rays_inner(rays_o, rays_d, near, far, ray_altitude_range)


def compute_image_rays(c2w: np.ndarray, w: int, h: int,
                       intrinsics: np.ndarray, center_pixels: bool,
                       near: float, far: float,
                       ray_altitude_range: Optional[Sequence[float]] = None
                       ) -> np.ndarray:
    """Whole-image rays [H*W, 8]."""
    directions = get_ray_directions(w, h, intrinsics[0], intrinsics[1],
                                    intrinsics[2], intrinsics[3],
                                    center_pixels)
    return get_rays(directions, np.asarray(c2w, np.float32), near, far,
                    ray_altitude_range).reshape(-1, 8)


def get_rays_batch(directions: np.ndarray, c2w: np.ndarray, near: float,
                   far: float,
                   ray_altitude_range: Optional[Sequence[float]] = None
                   ) -> np.ndarray:
    """directions [n, P, 3], c2w [n, 3, 4] -> rays [n, P, 8]."""
    rays_d = directions @ np.swapaxes(c2w[:, :, :3], 1, 2)
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:, None, :, 3], rays_d.shape).copy()
    return _get_rays_inner(rays_o, rays_d, near, far, ray_altitude_range)
