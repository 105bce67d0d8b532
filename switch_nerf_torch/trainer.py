"""Evaluation step of the port (the serving path).

Port of the eval part of ``switch_nerf_tpu/trainer.py`` (``SceneInfo``,
``render_config_from_hparams``, ``make_model_fn``, ``make_eval_step``,
``:59-148, 290-313``). Training waits for a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from switch_nerf_torch import resolve_device
from switch_nerf_torch.render.rendering import RenderConfig, render_rays

__all__ = ["SceneInfo", "render_config_from_hparams", "make_model_fn",
           "make_eval_step"]


@dataclasses.dataclass(frozen=True)
class SceneInfo:
    """Static per-scene geometry for the fg/bg split."""
    sphere_center: Optional[Any] = None   # [3]
    sphere_radius: Optional[Any] = None   # [3] (ellipse) or scalar


def render_config_from_hparams(hparams) -> RenderConfig:
    for flag in ("use_cascade", "use_mip", "return_pts", "return_pts_rgb",
                 "return_pts_alpha", "return_sigma", "return_alpha"):
        if getattr(hparams, flag, False):
            raise NotImplementedError(
                f"--{flag} waits for a later slice of the port")
    if hparams.sh_deg is not None or hparams.fine_samples <= 0:
        raise NotImplementedError(
            "--sh_deg and coarse-only rendering wait for a later slice")
    return RenderConfig(
        coarse_samples=hparams.coarse_samples,
        fine_samples=hparams.fine_samples,
        model_chunk_size=hparams.model_chunk_size,
        bg_model_chunk_size=getattr(hparams, "bg_model_chunk_size", None),
        pos_dir_dim=hparams.pos_dir_dim,
        white_bkgd=hparams.white_bkgd)


def make_model_fn(model: nn.Module) -> Callable:
    """Adapt a module to the renderer's contract:
    model_fn(points [P, D]) -> (outputs [P, 4], moe_loss [L])."""
    def model_fn(pts):
        out = model(pts)
        if isinstance(out, dict):
            moe = out["extras"].get("moe_loss")
            if moe is None:
                moe = pts.new_zeros((0,))
            return out["outputs"], moe
        return out, pts.new_zeros((0,))
    return model_fn


def _as_tensor(v, device) -> Optional[torch.Tensor]:
    if v is None:
        return None
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def make_eval_step(model: nn.Module, bg_model: Optional[nn.Module], hparams,
                   render_cfg: RenderConfig, scene: SceneInfo, *,
                   device=None) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """eval_step(batch) -> results dict, on ``device`` (default ``cuda``).

    batch: {"rays": [N, 8] (o, d, near, far), optional "image_indices": [N]},
    numpy arrays or tensors. The models must already live on the device.
    """
    dev = resolve_device(device)
    for name, m in (("model", model), ("bg_model", bg_model)):
        if m is not None and any(p.device != dev for p in m.parameters()):
            raise ValueError(f"{name} has parameters off {dev}")
    center = _as_tensor(scene.sphere_center, dev)
    radius = _as_tensor(scene.sphere_radius, dev)
    model_fn = make_model_fn(model)
    bg_fn = make_model_fn(bg_model) if bg_model is not None else None

    @torch.no_grad()
    def eval_step(batch) -> Dict[str, torch.Tensor]:
        rays = _as_tensor(batch["rays"], dev)
        image_indices = (_as_tensor(batch.get("image_indices"), dev)
                         if hparams.appearance_dim > 0 else None)
        return render_rays(model_fn, bg_fn, rays, image_indices, render_cfg,
                           center, radius, get_depth=True,
                           # fg/bg decomposition for the eval viz protocol
                           get_bg_fg_rgb=True)
    return eval_step
