"""Coarse/fine model pair (--use_cascade).

Port of ``switch_nerf_tpu/models/cascade.py:16-38``: two models of the
same architecture with their own parameters, ``coarse`` and ``fine`` (no
fine level when --fine_samples is 0). A call picks the level with
``use_coarse``; its default, the coarse level, is what a direct query
(eval_points, the octree's sigma grid) gets, as in JAX. The renderer
takes each level's model function from ``trainer.make_model_fn_pair``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["Cascade"]


class Cascade(nn.Module):
    def __init__(self, coarse: nn.Module, fine: Optional[nn.Module] = None):
        super().__init__()
        self.coarse = coarse
        self.fine = fine

    def forward(self, x: torch.Tensor,
                sigma_noise: Optional[torch.Tensor] = None,
                train: bool = False, sigma_only: bool = False,
                generator: Optional[torch.Generator] = None,
                use_coarse: bool = True):
        level = self.coarse if use_coarse or self.fine is None else self.fine
        return level(x, sigma_noise=sigma_noise, train=train,
                     sigma_only=sigma_only, generator=generator)
