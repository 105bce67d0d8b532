"""Classic (Mega-NeRF-style) ray rendering: coarse/fine hierarchical
sampling with foreground/background (inverted-sphere) composition.

Port of ``switch_nerf_tpu/render/rendering.py:98-574``, with the
coarse-only render (fine_samples 0: the coarse samples composited, no
fine pass), the cascade (--use_cascade: the coarse pass composited into
rgb_coarse, the fine pass on the fine model at the sorted union of the
coarse and fine depths, composited alone, fg and bg; the fg/bg
composition covers both levels), the per-sample introspection outputs
(return_pts / return_pts_rgb / return_pts_alpha / return_sigma /
return_alpha, of the coarse pass) and the SH colour step (sh_deg: the model
emits 3 x (deg+1)^2 coefficients a sample, evaluated at the ray direction
and squashed by a sigmoid). The JAX ``lax.scan`` over model chunks is a
Python loop here. In training with --remat (``remat_chunks``, on by
default, as in JAX) each model call keeps only its inputs and JAX's named
values (``remat.py``: the MoE routing plan and dispatch buffer, the
sigma noise, and the positional encodings off the mip renderer; the
chunk's draws always) and is recomputed in the backward; --no_remat keeps
every activation. Eval and anything under ``torch.no_grad`` run as they
are. Remat changes no value: gradients are bit-equal either way.

Training (``train=True``) adds the stratified jitter of the fg and bg
depths, random fine samples, per-chunk sigma noise and, with
--use_random_background_color, random background colours. All of it comes
from ONE ``torch.Generator`` on the rays' device, drawn in program order:

  background pass (when there is a bg model):
    1. jitter of the bg depths        U[0,1) [N, coarse/2]
    2. each coarse chunk's sigma noise N(0,1) [chunk, 1], then the
       model's own draws on that chunk (each MoE layer's gate noise and
       each dropout mask, in the layer walk's order), chunk order
    3. (cascade) the coarse composite's background colour U[0,1) [3]
    4. the fine queries               U[0,1) [N, fine/2]
    5. each fine chunk's sigma noise and model draws, as 2
    6. the fine composite's background colour U[0,1) [3]
  foreground pass: the same six draws at [N, coarse] and [N, fine].

A draw is skipped when its feature is off (perturb 0, no sigma noise, no
gate noise or dropout, no random background); without fine samples draws
3 to 5 go and draw 6 is the coarse composite's. The JAX package splits one
key per site instead, so the two frameworks draw different numbers: tests
inject the same draws or switch the noise off. The generator is a
training step's, checkpointed with the run, so a resumed run draws what
an uninterrupted one draws.

The `model_fn` contract:
    model_fn(points [P, D], sigma_noise [P, 1] | None, train, generator) ->
        (outputs [P, 4], moe_loss [L] fp32)   # L == 0 for dense models
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from switch_nerf_torch import remat
from switch_nerf_torch.ops.encoding import eval_sh
from switch_nerf_torch.ops.sorting import sort_with_payloads
from switch_nerf_torch.ops.volume import (
    depth2pts_outside, expand_and_perturb_z_vals, intersect_sphere,
    sample_pdf, volume_render)
from switch_nerf_torch.parallel import chunks

ModelFn = Callable[[torch.Tensor, Optional[torch.Tensor], bool],
                   Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    coarse_samples: int = 256
    fine_samples: int = 512
    perturb: float = 1.0                       # train only
    model_chunk_size: int = 131072
    bg_model_chunk_size: Optional[int] = None  # dense bg pass chunk size
    pos_dir_dim: int = 4
    use_cascade: bool = False                  # coarse/fine model pair
    white_bkgd: bool = False
    use_random_background_color: bool = False  # train only
    use_sigma_noise: bool = False              # train only
    sigma_noise_std: float = 1.0
    sh_deg: Optional[int] = None               # spherical-harmonics colour
    rgb_padding: Optional[float] = None        # mip only
    weights_resample_padding: float = 0.01     # mip only
    stop_level_grad: bool = True               # mip only
    return_pts: bool = False                   # per-sample xyz (coarse)
    return_pts_rgb: bool = False               # per-sample rgb (coarse)
    return_pts_alpha: bool = False             # per-sample alpha (coarse)
    return_sigma: bool = False                 # per-sample sigma (coarse)
    return_alpha: bool = False                 # the same alpha, its own key
    use_mip: bool = False                      # the mip renderer's model
    remat_chunks: bool = True                  # recompute each model call
    # keep the positional encodings across the remat boundary; None
    # resolves to `not use_mip` (JAX: +2.7 % on Building, -0.9 % on
    # Mission Bay on its chip), SWITCH_NERF_REMAT_SAVE overrides
    remat_save_pe: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class _Pass:
    """What one render call draws: train mode and its generator; `grid`
    places this rank's rays in a data-parallel step's global batch."""
    train: bool = False
    generator: Optional[torch.Generator] = None
    grid: Optional[chunks.RankGrid] = None


def run_model_chunked(model_fn: ModelFn, points: torch.Tensor,
                      cfg: RenderConfig, mode: _Pass = _Pass()):
    """Apply the model over full chunks of `model_chunk_size` points, then
    ONE exact-size call on the remainder.

    The chunking must match the JAX package's exactly: capacity and
    batch-prioritized routing are decided per chunk, so any other split
    drops other tokens. With `mode.grid` (a data-parallel train step) the
    chunks lie on the global batch's grid (``parallel/chunks.py``): this
    rank runs its piece of each, and a piece of a chunk that spans ranks
    routes with the other holders. Its moe_loss rows are then scaled by
    world * pieces / global chunks, so that the trainer's mean over them,
    averaged over the ranks, is JAX's mean over the global chunks. In
    training with --use_sigma_noise each call gets sigma_noise_std *
    N(0, 1) [rows, 1] fp32. A training call with grad enabled and
    ``remat_chunks`` runs under ``remat.checkpoint`` with the save set of
    ``remat.save_names`` (SWITCH_NERF_REMAT_SAVE read at each call); the
    piece's share goes into the call, whose recompute may run on the
    autograd engine's device thread, where the caller's context is not
    seen. Returns (outputs [P, C], moe_loss [n_calls, L]).
    """
    p = points.shape[0]
    if mode.grid is None:
        chunk = min(cfg.model_chunk_size, p)
        parts = [chunks.Piece(lo, min(lo + chunk, p), lo // chunk, None)
                 for lo in range(0, p, chunk)]
        scale = None
    else:
        parts, n_chunks = chunks.plan(p, cfg.model_chunk_size, mode.grid)
        scale = mode.grid.world * len(parts) / n_chunks
    noise = mode.train and cfg.use_sigma_noise and cfg.sigma_noise_std > 0.0
    names = None
    if mode.train and cfg.remat_chunks and torch.is_grad_enabled():
        names = remat.save_names(cfg.use_mip, cfg.remat_save_pe)
    outs, losses = [], []
    for piece in parts:
        pts = points[piece.start:piece.stop]
        sigma_noise = None
        if noise:
            sigma_noise = cfg.sigma_noise_std * torch.randn(
                (pts.shape[0], 1), generator=mode.generator,
                dtype=torch.float32, device=pts.device)

        def call(pts, sigma_noise, share=piece.share):
            with chunks.sharing(share):
                return model_fn(pts, sigma_noise, mode.train, mode.generator)
        if names is None:
            out, moe_loss = call(pts, sigma_noise)
        else:
            out, moe_loss = remat.checkpoint(call, names, pts, sigma_noise)
        outs.append(out)
        losses.append(moe_loss)
    moe_loss = torch.stack(losses)
    if scale is not None and scale != 1.0:
        moe_loss = moe_loss * scale
    return torch.cat(outs, dim=0), moe_loss


def _sort_merge(z: torch.Tensor, rgbs: torch.Tensor, sigmas: torch.Tensor,
                depth_real: Optional[torch.Tensor] = None):
    """Sort samples by z along the last axis, carrying rgb/sigma (and
    depth_real) along."""
    ops = (rgbs[..., 0], rgbs[..., 1], rgbs[..., 2], sigmas)
    if depth_real is not None:
        ops = ops + (depth_real,)
    out = sort_with_payloads(z, *ops)
    z_s, rgb_s, sig_s = out[0], torch.stack(out[1:4], dim=-1), out[4]
    if depth_real is not None:
        return z_s, rgb_s, sig_s, out[5]
    return z_s, rgb_s, sig_s


def _build_points(xyz: torch.Tensor, rays_d: torch.Tensor,
                  image_indices: Optional[torch.Tensor],
                  pos_dir_dim: int) -> torch.Tensor:
    """[N, S, xd] (+dirs +image index broadcast over samples) -> [N*S, D]."""
    n, s, xd = xyz.shape
    parts = [xyz.reshape(n * s, xd)]
    if pos_dir_dim > 0:
        parts.append(rays_d.expand(n, s, 3).reshape(n * s, 3))
    if image_indices is not None:
        parts.append(image_indices.to(xyz.dtype)[:, None, None]
                     .expand(n, s, 1).reshape(n * s, 1))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _inference(model_fn: ModelFn, xyz: torch.Tensor, z_vals: torch.Tensor,
               rays_d: torch.Tensor, image_indices, cfg: RenderConfig,
               mode: _Pass, flip: bool, depth_real: Optional[torch.Tensor]):
    """Run the model on [N, S] samples; return raw (rgbs, sigmas), the z
    values and depth_real in model order, and moe_loss.

    When flip (background pass, samples ordered by increasing inverse
    depth), arrays are reversed so the model sees near->far ordering."""
    if flip:
        xyz = torch.flip(xyz, dims=(-2,))
        z_vals = torch.flip(z_vals, dims=(-1,))
        if depth_real is not None:
            depth_real = torch.flip(depth_real, dims=(-1,))
    n, s, _ = xyz.shape
    pts = _build_points(xyz, rays_d, image_indices, cfg.pos_dir_dim)
    out, moe_loss = run_model_chunked(model_fn, pts, cfg, mode)
    rgbs, sigmas = split_outputs(out.reshape(n, s, -1), rays_d, cfg)
    return rgbs, sigmas, z_vals, depth_real, moe_loss


def split_outputs(out: torch.Tensor, rays_d: torch.Tensor,
                  cfg: RenderConfig):
    """A model's outputs [N, S, C] -> (rgbs [N, S, 3], sigmas [N, S]); with
    sh_deg the SH coefficients evaluated at the ray directions [N, 1, 3]
    and squashed by a sigmoid."""
    if cfg.sh_deg is None:
        return out[..., :3], out[..., 3]
    k = (cfg.sh_deg + 1) ** 2
    n, s = out.shape[:2]
    coeffs = out[..., :3 * k].reshape(n, s, 3, k)
    rgbs = torch.sigmoid(eval_sh(cfg.sh_deg, coeffs,
                                 rays_d.expand(n, s, 3)))
    return rgbs, out[..., 3 * k]


def _composite(rgbs, sigmas, z_vals, last_delta, cfg: RenderConfig,
               mode: _Pass, flip: bool, depth_real=None, get_depth=False,
               get_depth_variance=False, composite_rgb: bool = True):
    background_color = None
    if (mode.train and cfg.use_random_background_color and composite_rgb
            and not cfg.white_bkgd):
        background_color = torch.rand(3, generator=mode.generator,
                                      device=rgbs.device)
    return volume_render(
        rgbs, sigmas, z_vals, last_delta, flip=flip,
        composite_rgb=composite_rgb, depth_real=depth_real,
        get_depth=get_depth, get_depth_variance=get_depth_variance,
        white_bkgd=cfg.white_bkgd, background_color=background_color)


def _adjust_last_delta(ld: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """For a finite last_delta, subtract the max z so the final interval
    ends at the sphere boundary."""
    finite = ld[:, 0] < 1e10
    diff = torch.where(finite, torch.max(z, dim=-1).values,
                       torch.zeros_like(ld[:, 0]))
    return ld - diff[:, None]


def render_rays(model_fn: ModelFn, bg_model_fn: Optional[ModelFn],
                rays: torch.Tensor, image_indices: Optional[torch.Tensor],
                cfg: RenderConfig, sphere_center: Optional[torch.Tensor],
                sphere_radius: Optional[torch.Tensor],
                get_depth: bool = False,
                get_bg_fg_rgb: bool = False, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                get_depth_variance: bool = False,
                grid: Optional[chunks.RankGrid] = None,
                model_fn_fine: Optional[ModelFn] = None,
                bg_model_fn_fine: Optional[ModelFn] = None
                ) -> Dict[str, torch.Tensor]:
    """rays: [N, 8] = [o, d, near, far]. Returns the JAX package's results
    dict (rgb_fine / depth_fine / depth_variance_fine / gate_loss_* / bg_*
    / fg_* ...). `generator` feeds every training draw (module docstring).
    `grid`: the rays are this rank's share of a data-parallel step's
    global batch (``run_model_chunked``). Without fine samples the coarse
    pass is composited into rgb_coarse / depth_coarse / ...
    model_fn_fine / bg_model_fn_fine: a cascade's fine level
    (``trainer.make_model_fn_pair``); default the same model."""
    model_fn_fine = model_fn_fine or model_fn
    bg_model_fn_fine = bg_model_fn_fine or bg_model_fn
    mode = _Pass(train, generator, grid)
    perturb = cfg.perturb if train else 0.0
    n_rays = rays.shape[0]
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    results: Dict[str, torch.Tensor] = {}

    has_bg = bg_model_fn is not None
    if has_bg:
        fg_far = intersect_sphere(rays_o, rays_d, sphere_center, sphere_radius)
        fg_far = torch.maximum(fg_far, near[:, 0])
        bg_mask = far[:, 0] > fg_far                               # [N]
        last_delta = torch.where(bg_mask, fg_far,
                                 torch.full_like(fg_far, 1e10))[:, None]
        far = torch.minimum(far[:, 0], fg_far)[:, None]
    else:
        bg_mask = None
        last_delta = torch.full((n_rays, 1), 1e10, dtype=rays.dtype,
                                device=rays.device)

    rays_o3 = rays_o[:, None, :]
    rays_d3 = rays_d[:, None, :]

    bg = {}
    if has_bg:
        bg = _render_background((bg_model_fn, bg_model_fn_fine), rays_o3,
                                rays_d3, image_indices, cfg, mode,
                                sphere_center, sphere_radius, get_depth)

    # ---------------- foreground coarse ------------------------------------
    z_steps = torch.linspace(0.0, 1.0, cfg.coarse_samples, dtype=rays.dtype,
                             device=rays.device)
    # near (1 - s) + far s and o + d z with their last product and sum in
    # one rounding (a fused multiply-add), as XLA computes them: the top PE
    # frequencies turn a last-bit difference in a point into gradient noise
    z_vals = torch.addcmul(near * (1 - z_steps), far, z_steps)
    z_vals = expand_and_perturb_z_vals(z_vals, perturb, generator)
    xyz_coarse = torch.addcmul(rays_o3, rays_d3, z_vals[..., None])
    rgbs_c, sigmas_c, zv_c, _, moe_loss_c = _inference(
        model_fn, xyz_coarse, z_vals, rays_d3, image_indices, cfg, mode,
        flip=False, depth_real=None)
    results["gate_loss_coarse"] = moe_loss_c.reshape(-1)

    # per-sample introspection outputs of the coarse pass
    if cfg.return_pts:
        results["pts_coarse"] = xyz_coarse
    if cfg.return_pts_rgb:
        results["pts_rgb_coarse"] = rgbs_c
    if cfg.return_sigma:
        results["sigma_coarse"] = sigmas_c
    if cfg.return_pts_alpha or cfg.return_alpha:
        deltas_c = torch.cat([zv_c[..., 1:] - zv_c[..., :-1],
                              _adjust_last_delta(last_delta, zv_c)], dim=-1)
        alphas_c = 1.0 - torch.exp(-deltas_c * sigmas_c)
        if cfg.return_pts_alpha:
            results["pts_alpha_coarse"] = alphas_c
        if cfg.return_alpha:
            results["alpha_coarse"] = alphas_c

    typ = "fine" if cfg.fine_samples > 0 else "coarse"
    if typ == "coarse":
        vr = _composite(rgbs_c, sigmas_c, zv_c,
                        _adjust_last_delta(last_delta, zv_c), cfg, mode,
                        flip=False, get_depth=get_depth,
                        get_depth_variance=get_depth_variance)
    else:
        vr_c = _composite(rgbs_c, sigmas_c, zv_c,
                          _adjust_last_delta(last_delta, zv_c), cfg, mode,
                          flip=False, composite_rgb=cfg.use_cascade)
        if cfg.use_cascade:
            results["rgb_coarse"] = vr_c.rgb
            if has_bg:
                results["bg_lambda_coarse"] = vr_c.bg_lambda
        z_mid = 0.5 * (zv_c[:, :-1] + zv_c[:, 1:])
        fine_z = sample_pdf(z_mid, vr_c.weights[:, 1:-1].detach(),
                            cfg.fine_samples, det=perturb == 0,
                            generator=generator)
        if cfg.use_cascade:
            fine_z = torch.sort(torch.cat([zv_c, fine_z], dim=-1),
                                dim=-1).values
        xyz_fine = torch.addcmul(rays_o3, rays_d3, fine_z[..., None])
        rgbs_f, sigmas_f, zv_f, _, moe_loss_f = _inference(
            model_fn_fine, xyz_fine, fine_z, rays_d3, image_indices, cfg,
            mode, flip=False, depth_real=None)
        results["gate_loss_fine"] = moe_loss_f.reshape(-1)

        if cfg.use_cascade:
            # the fine level's samples alone: they include the coarse z
            z_all, rgb_all, sig_all = zv_f, rgbs_f, sigmas_f
        else:
            # merge coarse + fine raw samples before compositing
            z_all, rgb_all, sig_all = _sort_merge(
                torch.cat([zv_f, zv_c], dim=-1),
                torch.cat([rgbs_f, rgbs_c], dim=-2),
                torch.cat([sigmas_f, sigmas_c], dim=-1))
        # reference quirk kept for parity: the fine last-delta adjustment
        # subtracts max(FINE z) only, though the composite runs on the
        # merged array whose max is the coarse far bound
        vr = _composite(rgb_all, sig_all, z_all,
                        _adjust_last_delta(last_delta, fine_z), cfg, mode,
                        flip=False, get_depth=get_depth or has_bg,
                        get_depth_variance=get_depth_variance)
    results[f"rgb_{typ}"] = vr.rgb
    if get_depth:
        results[f"depth_{typ}"] = vr.depth
    if get_depth_variance:
        results[f"depth_variance_{typ}"] = vr.depth_variance
    if has_bg:
        results[f"bg_lambda_{typ}"] = vr.bg_lambda

    # ---------------- fg/bg composition ------------------------------------
    if has_bg:
        m = bg_mask.to(rays.dtype)
        types = [typ] + (["coarse"] if cfg.use_cascade and typ == "fine"
                         else [])
        for t in types:
            bl = results[f"bg_lambda_{t}"]
            for key in ("rgb", "depth"):
                rk = f"{key}_{t}"
                if rk not in results or rk not in bg:
                    continue
                val = results[rk]
                if val.dim() == 1:
                    add = bg[rk] * (bl * m)
                else:
                    add = bg[rk] * bl[:, None] * m[:, None]
                if get_bg_fg_rgb:
                    results[f"fg_{rk}"] = val
                    results[f"bg_{rk}"] = add
                results[rk] = val + add
        for t in ("fine", "coarse"):
            if f"gate_loss_{t}" in bg:
                results[f"bg_gate_loss_{t}"] = bg[f"gate_loss_{t}"]
    return results


def _render_background(bg_model_fns, rays_o3, rays_d3, image_indices,
                       cfg: RenderConfig, mode: _Pass, sphere_center,
                       sphere_radius, get_depth):
    """Inverted-sphere background pass over ALL rays (the caller masks the
    composition), with half the coarse and half the fine samples (none:
    the coarse composite), ordered far->near. bg_model_fns: the (coarse,
    fine) model functions."""
    bg_model_fn, bg_model_fn_fine = bg_model_fns
    if cfg.bg_model_chunk_size:
        cfg = dataclasses.replace(cfg,
                                  model_chunk_size=cfg.bg_model_chunk_size)
    perturb = cfg.perturb if mode.train else 0.0
    n_rays = rays_o3.shape[0]
    s_bg = cfg.coarse_samples // 2
    bg_z = torch.linspace(0.0, 1.0, s_bg, dtype=rays_o3.dtype,
                          device=rays_o3.device).expand(n_rays, s_bg)
    bg_z = expand_and_perturb_z_vals(bg_z, perturb, mode.generator)
    bg_pts, depth_real = depth2pts_outside(rays_o3, rays_d3, bg_z,
                                           sphere_center, sphere_radius)
    last_delta = torch.full((n_rays, 1), 1e10, dtype=rays_o3.dtype,
                            device=rays_o3.device)

    results: Dict[str, torch.Tensor] = {}
    rgbs_c, sigmas_c, zv_c, dr_c, moe_loss_c = _inference(
        bg_model_fn, bg_pts, bg_z, rays_d3, image_indices, cfg, mode,
        flip=True, depth_real=depth_real)
    results["gate_loss_coarse"] = moe_loss_c.reshape(-1)

    if cfg.fine_samples <= 0:
        vr = _composite(rgbs_c, sigmas_c, zv_c, last_delta, cfg, mode,
                        flip=True, depth_real=dr_c, get_depth=get_depth)
        results["rgb_coarse"] = vr.rgb
        if get_depth:
            results["depth_coarse"] = vr.depth
        return results

    vr_c = _composite(rgbs_c, sigmas_c, zv_c, last_delta, cfg, mode,
                      flip=True, composite_rgb=cfg.use_cascade,
                      depth_real=dr_c)
    if cfg.use_cascade:
        results["rgb_coarse"] = vr_c.rgb
    # zv_c comes back flipped (descending inverse depth). As in the JAX
    # package (and the reference it follows), the ASCENDING mids of the
    # original bg z pair with the flipped-order weights.
    z_mid = torch.flip(0.5 * (zv_c[:, :-1] + zv_c[:, 1:]), dims=(-1,))
    fine_z = sample_pdf(z_mid, vr_c.weights[:, 1:-1].detach(),
                        cfg.fine_samples // 2, det=perturb == 0,
                        generator=mode.generator)
    # ascending order for depth2pts_outside (random draws come unsorted;
    # a cascade's fine level takes the union with the coarse depths)
    if cfg.use_cascade:
        fine_z = torch.cat([zv_c, fine_z], dim=-1)
    fine_z_asc = torch.sort(fine_z, dim=-1).values
    bg_pts_f, depth_real_f = depth2pts_outside(
        rays_o3, rays_d3, fine_z_asc, sphere_center, sphere_radius)
    rgbs_f, sigmas_f, zv_f, dr_f, moe_loss_f = _inference(
        bg_model_fn_fine, bg_pts_f, fine_z_asc, rays_d3, image_indices, cfg,
        mode, flip=True, depth_real=depth_real_f)
    results["gate_loss_fine"] = moe_loss_f.reshape(-1)

    if cfg.use_cascade:
        z_all, rgb_all, sig_all, dr_all = zv_f, rgbs_f, sigmas_f, dr_f
    else:
        # merge coarse + fine (descending z ordering -> sort on -z)
        z_neg, rgb_all, sig_all, dr_all = _sort_merge(
            -torch.cat([zv_f, zv_c], dim=-1),
            torch.cat([rgbs_f, rgbs_c], dim=-2),
            torch.cat([sigmas_f, sigmas_c], dim=-1),
            torch.cat([dr_f, dr_c], dim=-1))
        z_all = -z_neg
    vr_f = _composite(rgb_all, sig_all, z_all, last_delta, cfg, mode,
                      flip=True, depth_real=dr_all, get_depth=get_depth)
    results["rgb_fine"] = vr_f.rgb
    if get_depth:
        results["depth_fine"] = vr_f.depth
    return results
