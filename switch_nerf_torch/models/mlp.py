"""Plain and normalized MLP blocks with the reference's skip semantics.

Port of ``switch_nerf_tpu/models/mlp.py:19-75`` (Mlp, NormMlp): at a skip
layer, h += x BEFORE the activation (and NormMlp's LayerNorm) and x is
rebound to the post-skip h; the last layer never applies either.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from switch_nerf_torch.models.common import LayerNorm, TorchLinear, apply_act


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

    def _hidden(self, i: int, h: torch.Tensor) -> torch.Tensor:
        return apply_act(self.act, h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.layer_num):
            h = getattr(self, f"fc{i}")(h)
            if i in self.skips:
                h = h + x
                if i < self.layer_num - 1:
                    h = self._hidden(i, h)
                x = h
            elif i < self.layer_num - 1:
                h = self._hidden(i, h)
        return h


class NormMlp(Mlp):
    """Mlp with a LayerNorm (``norm{i}``, eps 1e-5) before each hidden
    activation when norm_name is 'layernorm'; 'none' is the plain Mlp. Any
    other norm raises, as in the JAX package."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, layer_num: int,
                 skips: Optional[Sequence[int]] = None, act: str = "relu",
                 norm_name: str = "none",
                 generator: Optional[torch.Generator] = None):
        if norm_name not in ("none", "layernorm"):
            raise NotImplementedError(norm_name)
        super().__init__(in_features, hidden_features, out_features,
                         layer_num, skips, act, generator)
        self.use_norm = norm_name == "layernorm"
        if self.use_norm:
            for i in range(layer_num - 1):
                self.add_module(f"norm{i}", LayerNorm(hidden_features))

    def _hidden(self, i: int, h: torch.Tensor) -> torch.Tensor:
        if self.use_norm:
            h = getattr(self, f"norm{i}")(h)
        return apply_act(self.act, h)
