"""Dense (non-MoE) NeRF MLP: the background NeRF of the Mega-NeRF configs.

Port of ``switch_nerf_tpu/models/nerf.py:23-104``: frequency PE over xyz,
input-concat skips, an fp32 sigma head (where a sigma-only query ends),
then viewdir PE and the appearance embedding into the rgb head; with
affine_appearance the embedding drives a 3x4 colour transform of the rgb
head's output instead (with pos_dir_dim 0 too, the rgb head then reads the
trunk directly).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from switch_nerf_torch.models.common import Embedding, TorchLinear
from switch_nerf_torch.ops.encoding import freq_encode, shifted_softplus


class NeRF(nn.Module):
    def __init__(self, pos_xyz_dim: int = 12, pos_dir_dim: int = 4,
                 layers: int = 8, skip_layers: Sequence[int] = (4,),
                 layer_dim: int = 256, appearance_dim: int = 48,
                 affine_appearance: bool = False,
                 appearance_count: int = 0, rgb_dim: int = 3,
                 xyz_dim: int = 3, shifted_softplus_sigma: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 sigma_fp32: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pos_xyz_dim, self.pos_dir_dim = pos_xyz_dim, pos_dir_dim
        self.layers = layers
        self.skip_layers = tuple(skip_layers)
        self.appearance_dim = appearance_dim
        self.affine_appearance = affine_appearance
        self.rgb_dim, self.xyz_dim = rgb_dim, xyz_dim
        self.shifted_softplus_sigma = shifted_softplus_sigma
        self.compute_dtype, self.sigma_fp32 = compute_dtype, sigma_fp32
        has_dir, has_app = pos_dir_dim > 0, appearance_dim > 0

        pe = xyz_dim * (1 + 2 * pos_xyz_dim)
        width = pe
        for i in range(layers):
            if i in self.skip_layers:
                width += pe
            self.add_module(f"xyz_encoding_{i}",
                            TorchLinear(width, layer_dim, generator=generator))
            width = layer_dim
        self.sigma = TorchLinear(layer_dim, 1, generator=generator)
        self.use_dir_branch = has_dir or (has_app and not affine_appearance)
        if self.use_dir_branch:
            self.xyz_encoding_final = TorchLinear(layer_dim, layer_dim,
                                                  generator=generator)
            dir_in = layer_dim + (3 * (1 + 2 * pos_dir_dim) if has_dir else 0)
            if has_app and not affine_appearance:
                self.embedding_a = Embedding(appearance_count, appearance_dim,
                                             generator=generator)
                dir_in += appearance_dim
            self.dir_a_encoding = TorchLinear(dir_in, layer_dim // 2,
                                              generator=generator)
            self.rgb = TorchLinear(layer_dim // 2, rgb_dim,
                                   generator=generator)
        else:
            self.rgb = TorchLinear(layer_dim, rgb_dim, generator=generator)
        if affine_appearance and has_app:
            self.embedding_a = Embedding(appearance_count, appearance_dim,
                                         generator=generator)
            self.affine = TorchLinear(appearance_dim, 12, generator=generator)

    def forward(self, x: torch.Tensor,
                sigma_noise: Optional[torch.Tensor] = None,
                train: bool = False, sigma_only: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """x: [S, xyz_dim (+3 viewdir) (+1 appearance idx)] -> [S, rgb_dim+1];
        a sigma-only query passes the xyz columns alone -> sigma [S, 1].

        sigma_noise: [S, 1] added to the raw sigma before its activation
        (training only). `train` and `generator` are part of the models'
        common contract; the dense NeRF draws nothing and computes the
        same either way."""
        xd = self.xyz_dim
        has_dir, has_app = self.pos_dir_dim > 0, self.appearance_dim > 0
        expected = xd + (0 if sigma_only else
                         (3 if has_dir else 0) + (1 if has_app else 0))
        if x.shape[-1] != expected:
            raise ValueError(f"Unexpected input shape {tuple(x.shape)} "
                             f"(expected last dim {expected}, xyz_dim {xd})")

        input_xyz = freq_encode(x[:, :xd].to(self.compute_dtype),
                                self.pos_xyz_dim)
        h = input_xyz
        for i in range(self.layers):
            if i in self.skip_layers:
                h = torch.cat([input_xyz, h], dim=-1)
            h = torch.relu(getattr(self, f"xyz_encoding_{i}")(h))

        sigma = self.sigma(h.float() if self.sigma_fp32 else h)
        if sigma_noise is not None:
            sigma = sigma + sigma_noise.to(sigma.dtype)
        sigma = (shifted_softplus(sigma) if self.shifted_softplus_sigma
                 else torch.relu(sigma))
        if sigma_only:
            return sigma

        affine = self.affine_appearance and has_app
        if self.use_dir_branch:
            parts = [self.xyz_encoding_final(h)]
            if has_dir:
                parts.append(freq_encode(
                    x[:, xd:xd + 3].to(self.compute_dtype), self.pos_dir_dim))
            if has_app and not affine:
                parts.append(self.embedding_a(x[:, -1].long())
                             .to(self.compute_dtype))
            h2 = torch.relu(self.dir_a_encoding(torch.cat(parts, dim=-1)))
            rgb = self.rgb(h2)
        else:
            rgb = self.rgb(h)
        if affine:
            a = self.embedding_a(x[:, -1].long()).to(self.compute_dtype)
            m = self.affine(a).reshape(-1, 3, 4)
            rgb = torch.einsum("sij,sj->si", m[:, :, :3], rgb) + m[:, :, 3]
        if self.rgb_dim == 3:
            rgb = torch.sigmoid(rgb)
        return torch.cat([rgb, sigma.to(rgb.dtype)], dim=-1)
