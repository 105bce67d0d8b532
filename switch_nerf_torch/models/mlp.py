"""Plain MLP block with the reference's skip semantics.

Port of ``switch_nerf_tpu/models/mlp.py:19-41`` (Mlp): at a skip layer,
h += x BEFORE the activation and x is rebound to the post-skip h; the last
layer never applies the activation.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from switch_nerf_torch.models.common import TorchLinear, apply_act


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, layer_num: int,
                 skips: Optional[Sequence[int]] = None, act: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layer_num = layer_num
        self.skips = set(skips or ())
        self.act = act
        width = in_features
        for i in range(layer_num):
            out_ch = out_features if i == layer_num - 1 else hidden_features
            self.add_module(f"fc{i}", TorchLinear(width, out_ch,
                                                  generator=generator))
            width = out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.layer_num):
            h = getattr(self, f"fc{i}")(h)
            if i in self.skips:
                h = h + x
                if i < self.layer_num - 1:
                    h = apply_act(self.act, h)
                x = h
            elif i < self.layer_num - 1:
                h = apply_act(self.act, h)
        return h
