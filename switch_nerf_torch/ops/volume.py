"""Volume-rendering math: alpha compositing, stratified and PDF sampling,
and the foreground/background (inverted-sphere) geometry helpers.

Port of ``switch_nerf_tpu/ops/volume.py:37-254``. Each random function
takes either a ``torch.Generator`` or the uniform draw ``u`` itself, so a
test can feed both frameworks the same numbers (the two generators differ).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = [
    "VolumeResults", "volume_render", "expand_and_perturb_z_vals",
    "sample_pdf", "sample_cdf", "interval_lookup", "intersect_sphere",
    "depth2pts_outside",
]


class VolumeResults(NamedTuple):
    rgb: Optional[torch.Tensor]        # [N, 3] (None unless composite_rgb)
    depth: Optional[torch.Tensor]      # [N]
    depth_variance: Optional[torch.Tensor]  # [N]
    weights: torch.Tensor              # [N, S]
    alphas: torch.Tensor               # [N, S]
    transmittance: torch.Tensor        # [N, S] T_i (shifted, leading 1)
    bg_lambda: torch.Tensor            # [N] last unshifted T


def _uniform(shape, like: torch.Tensor,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """U[0, 1) of `shape` in like's dtype, on like's device."""
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device)


def volume_render(rgbs: torch.Tensor, sigmas: torch.Tensor,
                  z_vals: torch.Tensor, last_delta: torch.Tensor, *,
                  flip: bool = False, composite_rgb: bool = True,
                  depth_real: Optional[torch.Tensor] = None,
                  get_depth: bool = False, get_depth_variance: bool = False,
                  white_bkgd: bool = False,
                  background_color: Optional[torch.Tensor] = None
                  ) -> VolumeResults:
    """Classic NeRF compositing.

    rgbs: [N, S, 3]; sigmas: [N, S]; z_vals: [N, S]; last_delta: [N, 1].
    flip=True means samples run far->near (background pass), so deltas are
    z[i] - z[i+1]. Depth and its variance carry no gradient (the JAX
    package's stop_gradients).
    """
    if flip:
        deltas = z_vals[..., :-1] - z_vals[..., 1:]
    else:
        deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, last_delta], dim=-1)               # [N, S]

    alphas = 1.0 - torch.exp(-deltas * sigmas)                     # [N, S]
    t_full = torch.cumprod(1.0 - alphas + 1e-8, dim=-1)            # [N, S]
    bg_lambda = t_full[..., -1]
    t_shift = torch.cat([torch.ones_like(t_full[..., :1]), t_full[..., :-1]],
                        dim=-1)
    weights = alphas * t_shift                                     # [N, S]

    rgb = None
    if composite_rgb:
        rgb = torch.sum(weights[..., None] * rgbs, dim=-2)         # [N, 3]
        if white_bkgd:
            rgb = rgb + (1.0 - torch.sum(weights, dim=-1)[..., None])
        elif background_color is not None:
            rgb = rgb + ((1.0 - torch.sum(weights, dim=-1)[..., None])
                         * background_color)

    depth = depth_variance = None
    if get_depth or get_depth_variance:
        dr = (depth_real if depth_real is not None else z_vals).detach()
        w = weights.detach()
        depth_map = torch.sum(w * dr, dim=-1)
        if get_depth:
            depth = depth_map
        if get_depth_variance:
            depth_variance = torch.sum(
                w * torch.square(z_vals.detach() - depth_map[..., None]),
                dim=-1)

    return VolumeResults(rgb=rgb, depth=depth, depth_variance=depth_variance,
                         weights=weights, alphas=alphas,
                         transmittance=t_shift, bg_lambda=bg_lambda)


def expand_and_perturb_z_vals(z_vals: torch.Tensor, perturb: float,
                              generator: Optional[torch.Generator] = None,
                              u: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Stratified jitter of sample depths. z_vals: [N, S] (expanded).

    No jitter when perturb <= 0 or neither a generator nor a draw `u`
    (U[0, 1) of z_vals' shape) is given, as in the JAX package."""
    if perturb <= 0 or (generator is None and u is None):
        return z_vals
    mids = 0.5 * (z_vals[..., :-1] + z_vals[..., 1:])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    if u is None:
        u = _uniform(z_vals.shape, z_vals, generator)
    return lower + (upper - lower) * (perturb * u)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, fine_samples: int,
               det: bool = True, generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling. bins: [N, B+1], weights: [N, B]."""
    weights = weights + 1e-8
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    return sample_cdf(bins, cdf, fine_samples, det, generator, u)


def sample_cdf(bins: torch.Tensor, cdf: torch.Tensor, fine_samples: int,
               det: bool = True, generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deterministic (linspace) queries when det or neither a generator nor
    a draw `u` [N, fine_samples] is given; else random ones."""
    n_rays = cdf.shape[0]
    cdf = torch.cat([cdf.new_zeros((n_rays, 1)), cdf], dim=-1)     # [N, B+1]
    if det or (generator is None and u is None):
        u = torch.linspace(0.0, 1.0, fine_samples, dtype=cdf.dtype,
                           device=cdf.device).expand(n_rays, fine_samples)
    elif u is None:
        u = _uniform((n_rays, fine_samples), cdf, generator)
    cdf_below, cdf_above, bins_below, bins_above = interval_lookup(
        cdf, bins, u)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-8, torch.ones_like(denom), denom)
    return bins_below + (u - cdf_below) / denom * (bins_above - bins_below)


def interval_lookup(cdf: torch.Tensor, bins: torch.Tensor, u: torch.Tensor):
    """For each query u, the bracketing (cdf, bin) pairs.

    inds = searchsorted(cdf, u, side='right'); below = inds - 1 (>= 0 since
    cdf[..., 0] == 0 <= u); above = min(inds, B). This is the definition the
    JAX package's sort-based lookup states and implements
    (``switch_nerf_tpu/ops/volume.py:139-192``).
    """
    last = cdf.shape[-1] - 1
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=last)
    return (torch.gather(cdf, -1, below), torch.gather(cdf, -1, above),
            torch.gather(bins, -1, below), torch.gather(bins, -1, above))


def intersect_sphere(rays_o: torch.Tensor, rays_d: torch.Tensor,
                     sphere_center: Optional[torch.Tensor],
                     sphere_radius: Optional[torch.Tensor]) -> torch.Tensor:
    """Depth of each ray's exit from the unit sphere (p_norm_sq clamped into
    [0, 1), as in the JAX package)."""
    if sphere_radius is not None:
        rays_o = (rays_o - sphere_center) / sphere_radius
        rays_d = rays_d / sphere_radius
    d1 = -torch.sum(rays_d * rays_o, dim=-1) / torch.sum(rays_d * rays_d, dim=-1)
    p = rays_o + d1[..., None] * rays_d
    ray_d_cos = 1.0 / torch.linalg.norm(rays_d, dim=-1)
    p_norm_sq = torch.clamp(torch.sum(p * p, dim=-1), 0.0, 1.0 - 1e-6)
    d2 = torch.sqrt(1.0 - p_norm_sq) * ray_d_cos
    return d1 + d2


def depth2pts_outside(rays_o: torch.Tensor, rays_d: torch.Tensor,
                      depth: torch.Tensor,
                      sphere_center: Optional[torch.Tensor],
                      sphere_radius: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverted-sphere background points (NeRF++ parameterization).

    rays_o/rays_d: [N, 1, 3]; depth: [N, S] in (0, 1] (inverse distance).
    Returns pts [N, S, 4] and depth_real [N, S].
    """
    if sphere_radius is not None:
        rays_o = (rays_o - sphere_center) / sphere_radius
        rays_d = rays_d / sphere_radius

    d1 = -torch.sum(rays_d * rays_o, dim=-1) / torch.sum(rays_d * rays_d, dim=-1)
    p_mid = rays_o + d1[..., None] * rays_d
    p_mid_norm = torch.linalg.norm(p_mid, dim=-1)                  # [N, 1]
    ray_d_cos = 1.0 / torch.linalg.norm(rays_d, dim=-1)
    d2 = torch.sqrt(torch.clamp(1.0 - p_mid_norm * p_mid_norm, min=0.0)) \
        * ray_d_cos
    p_sphere = rays_o + (d1 + d2)[..., None] * rays_d              # [N, 1, 3]

    rot_axis = torch.linalg.cross(rays_o, p_sphere, dim=-1)
    rot_axis = rot_axis / (torch.linalg.norm(rot_axis, dim=-1, keepdim=True)
                           + 1e-8)
    phi = torch.arcsin(torch.clamp(p_mid_norm, -1.0, 1.0))         # [N, 1]
    theta = torch.arcsin(torch.clamp(p_mid_norm * depth, -1.0, 1.0))  # [N, S]
    rot_angle = (phi - theta)[..., None]                           # [N, S, 1]

    cos_a = torch.cos(rot_angle)
    sin_a = torch.sin(rot_angle)
    shape3 = rot_angle.shape[:-1] + (3,)
    p_sphere_new = (p_sphere * cos_a
                    + torch.linalg.cross(rot_axis.expand(shape3),
                                         p_sphere.expand(shape3), dim=-1)
                    * sin_a
                    + rot_axis * torch.sum(rot_axis * p_sphere, dim=-1,
                                           keepdim=True) * (1.0 - cos_a))
    p_sphere_new = p_sphere_new / torch.linalg.norm(p_sphere_new, dim=-1,
                                                    keepdim=True)

    depth_real = 1.0 / (depth + 1e-8) * torch.cos(theta) + d1
    pts = torch.cat([p_sphere_new, depth[..., None]], dim=-1)
    return pts, depth_real
