"""Positional encodings and the sigma activation.

Port of ``switch_nerf_tpu/ops/encoding.py:22-89`` (freq_bands, freq_encode,
mip_encode, shifted_softplus). Elementwise ops: no kernel.
"""
from __future__ import annotations

import math

import torch

__all__ = ["freq_bands", "freq_encode", "mip_encode", "shifted_softplus"]


def freq_bands(num_freqs: int, logscale: bool = True, base: float = 2.0,
               device=None) -> torch.Tensor:
    """Frequency ladder 2^0..2^(n-1) (logscale) or linspace(1, 2^(n-1))."""
    if num_freqs <= 0:
        return torch.zeros((0,), dtype=torch.float32, device=device)
    if logscale:
        return base ** torch.linspace(0.0, num_freqs - 1, num_freqs,
                                      device=device)
    return torch.linspace(base ** 0.0, base ** (num_freqs - 1), num_freqs,
                          device=device)


def freq_encode(x: torch.Tensor, num_freqs: int,
                logscale: bool = True) -> torch.Tensor:
    """(x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...).

    x: [..., D] -> [..., D * (1 + 2*num_freqs)]. The angles are built in
    x's dtype, and cos(a) is taken as sin(a + pi/2) with pi/2 rounded to
    that dtype, exactly as the JAX package does (under bf16 AMP the phase
    is bf16(pi/2), not pi/2).
    """
    if num_freqs == 0:
        return x
    d = x.shape[-1]
    bands = freq_bands(num_freqs, logscale, device=x.device).to(x.dtype)
    phase = torch.tensor([0.0, 0.5 * math.pi], dtype=x.dtype,
                         device=x.device)                        # [2]
    angles = (x[..., None, None, :] * bands[:, None, None]
              + phase[:, None])                                  # [.., F, 2, D]
    sc = torch.sin(angles.reshape(*x.shape[:-1], 2 * num_freqs * d))
    return torch.cat([x, sc], dim=-1)


def mip_encode(mean_cov: torch.Tensor, num_freqs: int, logscale: bool = True,
               input_dims: int = 3) -> torch.Tensor:
    """Integrated positional encoding over (mean, diagonal covariance).

    mean_cov: [..., 2*D] = concat(mean, var). Returns [..., D + 2*F*D]: the
    mean, then per frequency f_k the [sin, cos] of f_k * mean attenuated by
    exp(-0.5 * 4^k * var), with freq_encode's single sin(a + phase).
    """
    d = input_dims
    mean, var = mean_cov[..., :d], mean_cov[..., d:2 * d]
    if num_freqs == 0:
        return mean
    fy = freq_bands(num_freqs, logscale, device=mean.device).to(mean.dtype)
    fw = freq_bands(num_freqs, logscale, base=4.0,
                    device=mean.device).to(mean.dtype)
    phase = torch.tensor([0.0, 0.5 * math.pi], dtype=mean.dtype,
                         device=mean.device)
    angles = (mean[..., None, None, :] * fy[:, None, None]
              + phase[:, None])                                # [.., F, 2, D]
    atten = torch.exp(-0.5 * var[..., None, None, :] * fw[:, None, None])
    flat = (*mean.shape[:-1], 2 * num_freqs * d)
    sc = (torch.sin(angles.reshape(flat))
          * atten.expand(angles.shape).reshape(flat))
    return torch.cat([mean, sc], dim=-1)


def shifted_softplus(x: torch.Tensor, beta: float = 1.0,
                     threshold: float = 20.0) -> torch.Tensor:
    """softplus(x - 1): the sigma activation used throughout the reference."""
    y = x - 1.0
    by = beta * y
    soft = torch.logaddexp(by, torch.zeros_like(by)) / beta
    return torch.where(by > threshold, y, soft)
