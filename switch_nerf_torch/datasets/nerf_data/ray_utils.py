"""Classic-NeRF camera rays (OpenGL convention, pixel corners).

Port of ``switch_nerf_tpu/datasets/nerf_data/ray_utils.py:13-43``:
``get_rays`` (directions ((i - cx) / fx, -(j - cy) / fy, -1), neither
normalized nor shifted to pixel centres, unlike the Mega-NeRF rays,
rotated by the camera, and the origin broadcast) and ``ndc_rays`` (the NDC
shift of forward-facing LLFF scenes). Also the area resample that stands
in for OpenCV's ``INTER_AREA`` (OpenCV is not among the card machine's
packages).
"""
from __future__ import annotations

import numpy as np

__all__ = ["get_rays", "ndc_rays", "area_downsample"]


def get_rays(h: int, w: int, k: np.ndarray, c2w: np.ndarray):
    """(rays_o [H, W, 3], rays_d [H, W, 3]) float32; directions not
    normalized."""
    i, j = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - k[0, 2]) / k[0, 0],
                     -(j - k[1, 2]) / k[1, 1],
                     -np.ones_like(i)], axis=-1)
    rays_d = np.sum(dirs[..., None, :] * c2w[:3, :3], axis=-1)
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape).copy()
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def ndc_rays(h: int, w: int, focal: float, near: float,
             rays_o: np.ndarray, rays_d: np.ndarray):
    """Shift the ray origins to the near plane and map the rays into NDC
    space; float32 (rays_o, rays_d)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (w / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (h / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (w / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2]
                                       - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (h / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2]
                                       - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]

    rays_o = np.stack([o0, o1, o2], axis=-1)
    rays_d = np.stack([d0, d1, d2], axis=-1)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def area_downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """An [H, W, C] image shrunk by a whole factor as ``INTER_AREA`` does:
    each output pixel is the mean of its factor x factor block. float32 in,
    float32 out; uint8 in, uint8 out, rounded as OpenCV rounds (half up at
    factor 2, its fast path; half to even otherwise). H and W must divide
    by the factor."""
    if factor == 1:
        return img
    h, w = img.shape[:2]
    if h % factor or w % factor:
        raise ValueError(f"a {w}x{h} image does not divide by {factor}")
    blocks = img.reshape(h // factor, factor, w // factor, factor,
                         *img.shape[2:])
    if img.dtype == np.uint8:
        sums = blocks.astype(np.int64).sum(axis=(1, 3))
        area = factor * factor
        if factor == 2:
            return ((sums * 2 + area) // (2 * area)).astype(np.uint8)
        return np.rint(sums / area).astype(np.uint8)
    return blocks.astype(np.float32).mean(axis=(1, 3), dtype=np.float32)
