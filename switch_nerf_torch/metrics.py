"""Image-quality metrics: PSNR / SSIM (+ masked variants) and LPIPS.

Port of ``switch_nerf_tpu/metrics.py``. Inputs are [H, W, C] images
(arrays or tensors); everything computes in fp32 on the device of the
first image (the runner passes tensors on its device) and returns Python
floats.
  * psnr / psnr_mask: mse -> -10 log10
  * ssim / ssim_mask: the separable-Gaussian formulation modeled after
    tf.image.ssim (filter 11, sigma 1.5, k1 .01, k2 .03, zero padding, the
    same variance clamps)
  * lpips: VGG/Alex/Squeeze (``lpips_torch``) with converted weights from
    SWITCH_NERF_LPIPS_WEIGHTS or <repo>/weights/lpips.npz, else the
    documented deterministic substitute under ``<net>-substitute`` keys;
    SWITCH_NERF_LPIPS_SUBSTITUTE=0 turns the substitute off.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from switch_nerf_torch import lpips_torch as L


def _tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)          # torch takes no negative strides
    return torch.as_tensor(x, device=device)


def _f32(x, device=None) -> torch.Tensor:
    return _tensor(x, device).float()


def _mask(valid_mask, device) -> torch.Tensor:
    return _tensor(valid_mask, device).bool()


def psnr(rgbs, target_rgbs) -> float:
    rgbs = _f32(rgbs)
    mse = torch.mean(torch.square(rgbs - _f32(target_rgbs, rgbs.device)))
    return float(-10.0 * torch.log10(mse))


def psnr_mask(rgbs, target_rgbs, valid_mask) -> float:
    rgbs = _f32(rgbs)
    m = _mask(valid_mask, rgbs.device)
    r = rgbs[m]
    t = _f32(target_rgbs, rgbs.device)[m]
    return float(-10.0 * torch.log10(torch.mean(torch.square(r - t))))


def _gaussian_filt(filter_size: int, filter_sigma: float,
                   device) -> torch.Tensor:
    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((torch.arange(filter_size, dtype=torch.float32, device=device)
            - hw + shift) / filter_sigma) ** 2
    filt = torch.exp(-0.5 * f_i)
    return filt / torch.sum(filt)


def _ssim_map(rgbs: torch.Tensor, target_rgbs: torch.Tensor, max_val: float,
              filter_size: int, filter_sigma: float, k1: float, k2: float):
    """rgbs/target: [H, W, C] fp32. Returns the per-pixel ssim map
    [H, W, C]: a depthwise 1-D blur along W then along H, each with
    filter_size // 2 zeros on both sides (output shape == input shape)."""
    filt = _gaussian_filt(filter_size, filter_sigma, rgbs.device)
    hw = filter_size // 2
    c = rgbs.shape[-1]
    k_w = filt.view(1, 1, 1, -1).expand(c, 1, 1, filter_size)
    k_h = filt.view(1, 1, -1, 1).expand(c, 1, filter_size, 1)

    def filt_fn(z):
        x = z.permute(2, 0, 1)[None]                       # [1, C, H, W]
        x = F.conv2d(x, k_w, padding=(0, hw), groups=c)
        x = F.conv2d(x, k_h, padding=(hw, 0), groups=c)
        return x[0].permute(1, 2, 0)

    mu0 = filt_fn(rgbs)
    mu1 = filt_fn(target_rgbs)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = filt_fn(rgbs ** 2) - mu00
    sigma11 = filt_fn(target_rgbs ** 2) - mu11
    sigma01 = filt_fn(rgbs * target_rgbs) - mu01

    sigma00 = torch.clamp(sigma00, min=0.0)
    sigma11 = torch.clamp(sigma11, min=0.0)
    sigma01 = torch.sign(sigma01) * torch.minimum(
        torch.sqrt(sigma00 * sigma11), torch.abs(sigma01))

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    return numer / denom


def ssim(rgbs, target_rgbs, max_val: float, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03
         ) -> float:
    rgbs = _f32(rgbs)
    m = _ssim_map(rgbs, _f32(target_rgbs, rgbs.device), max_val,
                  filter_size, filter_sigma, k1, k2)
    return float(torch.mean(m))


def ssim_mask(rgbs, target_rgbs, max_val: float, valid_mask,
              filter_size: int = 11, filter_sigma: float = 1.5,
              k1: float = 0.01, k2: float = 0.03) -> float:
    rgbs = _f32(rgbs)
    m = _ssim_map(rgbs, _f32(target_rgbs, rgbs.device), max_val,
                  filter_size, filter_sigma, k1, k2)
    return float(torch.mean(m[_mask(valid_mask, rgbs.device)]))


_warned_no_lpips = False

# Default location for converted LPIPS weights, found from this package's
# directory (see scripts/convert_lpips_weights.py); the env var overrides.
_LPIPS_DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "weights", "lpips.npz")


def _resolve_lpips_weights() -> Optional[str]:
    p = os.environ.get("SWITCH_NERF_LPIPS_WEIGHTS")
    if p:
        # explicit user intent: a missing path must fail loudly, not fall
        # back to substitute numbers
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"SWITCH_NERF_LPIPS_WEIGHTS={p!r} does not exist")
        return p
    if os.path.exists(_LPIPS_DEFAULT_PATH):
        return _LPIPS_DEFAULT_PATH
    return None


def validate_lpips_setup() -> Optional[str]:
    """Resolve and schema-check the LPIPS weights once, at startup: a
    set-but-missing SWITCH_NERF_LPIPS_WEIGHTS or a malformed npz fails
    before eval begins. Returns the resolved path (None = substitute)."""
    path = _resolve_lpips_weights()      # raises on set-but-missing env
    if path is not None:
        L.load_and_validate(path)        # raises on layout mismatch
    return path


def _warn_once(msg: str) -> None:
    global _warned_no_lpips
    if not _warned_no_lpips:
        _warned_no_lpips = True
        logging.getLogger(__name__).warning(msg)


def lpips(rgbs, target_rgbs) -> Dict[str, Optional[float]]:
    """LPIPS(vgg/alex/squeeze) over [0, 1] images, on rgbs' device.

    With converted weights the keys are 'vgg'/'alex'/'squeeze'. With the
    substitute they are 'vgg-substitute'/..., so numbers made without
    pretrained backbones are told apart wherever they land. [0, 1] inputs,
    scaled to [-1, 1] here (the reference's normalize=True contract).
    """
    rgbs = _f32(rgbs) * 2.0 - 1.0
    target_rgbs = _f32(target_rgbs, rgbs.device) * 2.0 - 1.0
    weights_path = _resolve_lpips_weights()
    if weights_path is not None:
        return L.lpips_all(rgbs, target_rgbs, weights_path)
    if os.environ.get("SWITCH_NERF_LPIPS_SUBSTITUTE", "1") == "0":
        _warn_once(
            "LPIPS weights not found and the substitute is disabled "
            "(SWITCH_NERF_LPIPS_SUBSTITUTE=0): eval metrics will OMIT "
            "lpips_vgg/alex/squeeze; PSNR/SSIM are unaffected.")
        return {"vgg": None, "alex": None, "squeeze": None}
    _warn_once(
        "LPIPS weights not found (set SWITCH_NERF_LPIPS_WEIGHTS or run "
        "scripts/convert_lpips_weights.py): using the deterministic "
        "random-init substitute backbones (seed 0). Values are a valid "
        "relative perceptual distance but are NOT comparable to "
        "published LPIPS numbers.")
    vals = L.prepared_distances(rgbs, target_rgbs,
                                L.device_nets(None, str(rgbs.device)))
    return {f"{net}-substitute": v for net, v in vals.items()}
