"""Mip-NeRF ray rendering (the Bungee-NeRF path).

Port of ``switch_nerf_tpu/render/rendering_mip.py:31-210``:
``mip_cast_rays`` (a conical frustum's mean and diagonal covariance per
sample interval), ``sorted_piecewise_constant_pdf`` (resampling from the
blurred coarse weights), ``_mip_inference`` and ``render_rays_mip``
(coarse pass, blurred-weight fine pass, the SH colour step with --sh_deg,
rgb padding, compositing at the interval midpoints). z_vals carry S + 1
interval edges; the model sees S frustum means.

As in the JAX package, eval is deterministic on purpose: fine resampling
and the random background colour draw only in training (the reference
resamples at random whenever perturb > 0, so its eval is stochastic).
Training draws from ONE ``torch.Generator`` on the rays' device, in program
order:

    1. the stratified jitter of the coarse edges  U[0,1) [N, coarse]
    2. each coarse chunk's sigma noise             N(0,1) [chunk, 1]
    3. the coarse composite's background colour    U[0,1) [3]
    4. the fine resampling offsets                 U[0,1) [N, fine]
    5. each fine chunk's sigma noise
    6. the fine composite's background colour      U[0,1) [3]

A draw is skipped when its feature is off. The JAX package splits one key
per site, so the two frameworks draw different numbers: ``draws`` hands
the uniform draws in by name ("perturb", "fine", "bkgd_coarse",
"bkgd_fine"), which is how the tests feed both sides the same numbers.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from switch_nerf_torch.ops.volume import (expand_and_perturb_z_vals,
                                          volume_render)
from switch_nerf_torch.parallel import chunks
from switch_nerf_torch.render.rendering import (ModelFn, RenderConfig, _Pass,
                                                run_model_chunked,
                                                split_outputs)

FLOAT_EPS = float(torch.finfo(torch.float32).eps)

__all__ = ["mip_cast_rays", "sorted_piecewise_constant_pdf",
           "render_rays_mip"]


def mip_cast_rays(origin: torch.Tensor, direction: torch.Tensor,
                  radius: torch.Tensor, t: torch.Tensor):
    """origin/direction [N, 3], radius [N, 1], t [N, S+1] edges ->
    (mean [N, S, 3], cov_diag [N, S, 3])."""
    t0, t1 = t[..., :-1], t[..., 1:]
    c, d = (t0 + t1) / 2, (t1 - t0) / 2
    t_mean = c + (2 * c * d ** 2) / (3 * c ** 2 + d ** 2)
    t_var = (d ** 2) / 3 - (4 / 15) * ((d ** 4 * (12 * c ** 2 - d ** 2))
                                       / (3 * c ** 2 + d ** 2) ** 2)
    r_var = radius ** 2 * ((c ** 2) / 4 + (5 / 12) * d ** 2
                           - (4 / 15) * (d ** 4) / (3 * c ** 2 + d ** 2))
    mean = origin[..., None, :] + direction[..., None, :] * t_mean[..., None]
    null_outer_diag = 1 - (direction ** 2) / torch.sum(
        direction ** 2, -1, keepdim=True)
    cov_diag = (t_var[..., None] * (direction ** 2)[..., None, :]
                + r_var[..., None] * null_outer_diag[..., None, :])
    return mean, cov_diag


def sorted_piecewise_constant_pdf(bins: torch.Tensor, weights: torch.Tensor,
                                  num_samples: int, randomized: bool,
                                  generator: Optional[torch.Generator] = None,
                                  u: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Samples [N, num_samples] from the piecewise-constant PDF of weights
    [N, B] over sorted bins [N, B+1]. Randomized (training): stratified
    offsets, U[0,1) [N, num_samples] from ``generator`` or given as ``u``;
    otherwise evenly spaced."""
    eps = 1e-5
    weight_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0.0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding

    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                     torch.ones_like(cdf[..., :1])], dim=-1)   # [N, B+1]

    shape = list(cdf.shape[:-1]) + [num_samples]
    if randomized:
        s = 1 / num_samples
        if u is None:
            u = torch.rand(shape, generator=generator, dtype=torch.float32,
                           device=cdf.device)
        u = torch.arange(num_samples, dtype=torch.float32,
                         device=cdf.device) * s + u * (s - FLOAT_EPS)
        u = torch.clamp(u, max=1.0 - FLOAT_EPS)
    else:
        u = torch.linspace(0.0, 1.0 - FLOAT_EPS, num_samples,
                           device=cdf.device).expand(shape)

    mask = u[..., None, :] >= cdf[..., :, None]                 # [N, B+1, T]

    def find_interval(x):
        x0 = torch.max(torch.where(mask, x[..., None], x[..., :1, None]),
                       dim=-2).values
        x1 = torch.min(torch.where(~mask, x[..., None], x[..., -1:, None]),
                       dim=-2).values
        return x0, x1

    bins_g0, bins_g1 = find_interval(bins)
    cdf_g0, cdf_g1 = find_interval(cdf)
    denom = cdf_g1 - cdf_g0
    t = torch.clamp(torch.where(
        denom > 0, (u - cdf_g0) / torch.where(denom == 0,
                                              torch.ones_like(denom), denom),
        torch.zeros_like(denom)), 0.0, 1.0)
    return bins_g0 + t * (bins_g1 - bins_g0)


def _background(mode: _Pass, cfg: RenderConfig, draws: Mapping, name: str,
                device) -> Optional[torch.Tensor]:
    if not (mode.train and cfg.use_random_background_color):
        return None
    if name in draws:
        return draws[name]
    return torch.rand(3, generator=mode.generator, device=device)


def _mip_inference(model_fn: ModelFn, means, cov_diags, z_edges, rays_d,
                   image_indices, cfg: RenderConfig, mode: _Pass,
                   get_depth: bool, get_depth_variance: bool,
                   draws: Mapping, bkgd: str):
    n, s, _ = means.shape
    parts = [torch.cat([means, cov_diags], -1).reshape(n * s, 6)]
    if cfg.pos_dir_dim > 0:
        parts.append(rays_d.expand(n, s, 3).reshape(n * s, 3))
    if image_indices is not None:
        parts.append(image_indices.to(means.dtype)[:, None, None]
                     .expand(n, s, 1).reshape(n * s, 1))
    out, moe_loss = run_model_chunked(model_fn, torch.cat(parts, dim=-1),
                                      cfg, mode)
    rgbs, sigmas = split_outputs(out.reshape(n, s, -1), rays_d, cfg)
    if cfg.rgb_padding is not None:
        rgbs = rgbs * (1 + 2 * cfg.rgb_padding) - cfg.rgb_padding

    z_mid = 0.5 * (z_edges[..., 1:] + z_edges[..., :-1])
    last_delta = 1e10 * torch.ones((n, 1), dtype=z_mid.dtype,
                                   device=z_mid.device)
    vr = volume_render(rgbs, sigmas, z_mid, last_delta, composite_rgb=True,
                       get_depth=get_depth,
                       get_depth_variance=get_depth_variance,
                       white_bkgd=cfg.white_bkgd,
                       background_color=_background(mode, cfg, draws, bkgd,
                                                    means.device))
    return vr, moe_loss


def render_rays_mip(model_fn: ModelFn, rays: torch.Tensor,
                    radii: torch.Tensor,
                    image_indices: Optional[torch.Tensor],
                    cfg: RenderConfig, *, train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    get_depth: bool = False,
                    get_depth_variance: bool = False,
                    draws: Optional[Mapping[str, torch.Tensor]] = None,
                    grid: Optional[chunks.RankGrid] = None
                    ) -> Dict[str, torch.Tensor]:
    """rays [N, 8] = (o, d, near, far); radii [N, 1]. Returns rgb_coarse,
    rgb_fine, gate_loss_coarse / _fine and, when asked, depth_* and
    depth_variance_* of the last pass. `generator` feeds every training
    draw (module docstring); `draws` overrides any uniform draw by name;
    `grid` as in ``render_rays``."""
    draws = draws or {}
    mode = _Pass(train, generator, grid)
    perturb = cfg.perturb if train else 0.0
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]

    z_steps = torch.linspace(0.0, 1.0, cfg.coarse_samples, dtype=rays.dtype,
                             device=rays.device)
    z_vals = near * (1 - z_steps) + far * z_steps
    if perturb > 0:
        z_vals = expand_and_perturb_z_vals(z_vals, perturb, generator,
                                           u=draws.get("perturb"))
    means, cov_diags = mip_cast_rays(rays_o, rays_d, radii, z_vals)

    fine = cfg.fine_samples > 0
    results: Dict[str, torch.Tensor] = {}
    vr_c, moe_loss_c = _mip_inference(
        model_fn, means, cov_diags, z_vals, rays_d[:, None, :], image_indices,
        cfg, mode, get_depth=not fine and get_depth,
        get_depth_variance=not fine and get_depth_variance, draws=draws,
        bkgd="bkgd_coarse")
    results["rgb_coarse"] = vr_c.rgb
    results["gate_loss_coarse"] = moe_loss_c.reshape(-1)
    if not fine:
        if get_depth:
            results["depth_coarse"] = vr_c.depth
        if get_depth_variance:
            results["depth_variance_coarse"] = vr_c.depth_variance
        return results

    # blurred-weight resampling
    weights = vr_c.weights
    weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]],
                            dim=-1)
    weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
    weights_blur = 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])
    weights_prime = weights_blur + cfg.weights_resample_padding
    fine_z = sorted_piecewise_constant_pdf(
        z_vals, weights_prime, cfg.fine_samples, randomized=perturb > 0,
        generator=generator, u=draws.get("fine"))
    if cfg.stop_level_grad:
        fine_z = fine_z.detach()
    fine_z = torch.sort(fine_z, dim=-1).values

    means_f, cov_diags_f = mip_cast_rays(rays_o, rays_d, radii, fine_z)
    vr_f, moe_loss_f = _mip_inference(
        model_fn, means_f, cov_diags_f, fine_z, rays_d[:, None, :],
        image_indices, cfg, mode, get_depth=get_depth,
        get_depth_variance=get_depth_variance, draws=draws, bkgd="bkgd_fine")
    results["rgb_fine"] = vr_f.rgb
    results["gate_loss_fine"] = moe_loss_f.reshape(-1)
    if get_depth:
        results["depth_fine"] = vr_f.depth
    if get_depth_variance:
        results["depth_variance_fine"] = vr_f.depth_variance
    return results
