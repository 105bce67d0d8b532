"""Positional encodings, the sigma activation and spherical harmonics.

Port of ``switch_nerf_tpu/ops/encoding.py:22-147`` (freq_bands,
freq_encode, mip_encode, shifted_softplus, eval_sh). Elementwise ops: no
kernel. The encodings are JAX's ``pe_out``, kept across the remat
boundary when the save set holds it (``remat.py``).
"""
from __future__ import annotations

import functools
import math

import torch

from switch_nerf_torch import remat

__all__ = ["freq_bands", "freq_encode", "mip_encode", "shifted_softplus",
           "eval_sh"]


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


@functools.lru_cache(maxsize=16)
def _phase(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[0, pi/2] in `dtype` on `device`, made once: a copy from the host
    at each call waits for the device, and cannot be captured in a CUDA
    graph (``graphs.py``)."""
    return torch.tensor([0.0, 0.5 * math.pi], dtype=dtype, device=device)


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
    # kept across the remat boundary as pe_out (remat.py)
    return remat.keep(_freq_encode, x, num_freqs, logscale, name="pe_out")


def _freq_encode(x: torch.Tensor, num_freqs: int,
                 logscale: bool) -> torch.Tensor:
    d = x.shape[-1]
    bands = freq_bands(num_freqs, logscale, device=x.device).to(x.dtype)
    phase = _phase(x.dtype, x.device)                            # [2]
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
    if num_freqs == 0:
        return mean_cov[..., :input_dims]
    # kept across the remat boundary as pe_out (remat.py)
    return remat.keep(_mip_encode, mean_cov, num_freqs, logscale,
                      input_dims, name="pe_out")


def _mip_encode(mean_cov: torch.Tensor, num_freqs: int, logscale: bool,
                d: int) -> torch.Tensor:
    mean, var = mean_cov[..., :d], mean_cov[..., d:2 * d]
    fy = freq_bands(num_freqs, logscale, device=mean.device).to(mean.dtype)
    fw = freq_bands(num_freqs, logscale, base=4.0,
                    device=mean.device).to(mean.dtype)
    phase = _phase(mean.dtype, mean.device)
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


# spherical harmonics (the PlenOctree convention), degrees 0-4
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """The spherical harmonics of degree `deg` (0-4) with coefficients sh
    [..., C, (deg+1)**2] at unit directions dirs [..., 3] -> [..., C],
    summed in the JAX package's order."""
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree {deg} not in 0..4")
    if sh.shape[-1] != (deg + 1) ** 2:
        raise ValueError(f"{sh.shape[-1]} SH coefficients for degree {deg}")
    result = _C0 * sh[..., 0]
    if deg == 0:
        return result
    x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    result = (result - _C1 * y * sh[..., 1] + _C1 * z * sh[..., 2]
              - _C1 * x * sh[..., 3])
    if deg == 1:
        return result
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    result = (result
              + _C2[0] * xy * sh[..., 4]
              + _C2[1] * yz * sh[..., 5]
              + _C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
              + _C2[3] * xz * sh[..., 7]
              + _C2[4] * (xx - yy) * sh[..., 8])
    if deg == 2:
        return result
    result = (result
              + _C3[0] * y * (3 * xx - yy) * sh[..., 9]
              + _C3[1] * xy * z * sh[..., 10]
              + _C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
              + _C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
              + _C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
              + _C3[5] * z * (xx - yy) * sh[..., 14]
              + _C3[6] * x * (xx - 3 * yy) * sh[..., 15])
    if deg == 3:
        return result
    return (result
            + _C4[0] * xy * (xx - yy) * sh[..., 16]
            + _C4[1] * yz * (3 * xx - yy) * sh[..., 17]
            + _C4[2] * xy * (7 * zz - 1) * sh[..., 18]
            + _C4[3] * yz * (7 * zz - 3) * sh[..., 19]
            + _C4[4] * (zz * (35 * zz - 30) + 3) * sh[..., 20]
            + _C4[5] * xz * (7 * zz - 3) * sh[..., 21]
            + _C4[6] * (xx - yy) * (7 * zz - 1) * sh[..., 22]
            + _C4[7] * xz * (xx - 3 * yy) * sh[..., 23]
            + _C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))
            * sh[..., 24])
