"""Shared layers: torch-default init, the dtype-following Linear, the
appearance embedding, LayerNorm and GroupNorm with fp32 output, dropout,
activations.

Port of ``switch_nerf_tpu/models/common.py``. Every init draws from an
explicit ``torch.Generator``: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight
and bias (torch's nn.Linear default), normal(0, 1) for the embedding.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from switch_nerf_torch import remat
from switch_nerf_torch.ops.embedding import embedding

__all__ = ["uniform_fan_in", "TorchLinear", "Embedding", "LayerNorm",
           "GroupNorm", "Dropout", "apply_act"]


def uniform_fan_in(shape, fan_in: int, generator: Optional[torch.Generator],
                   factor: float = 1.0) -> nn.Parameter:
    bound = 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape).uniform_(-bound, bound, generator=generator)
    return nn.Parameter(t * factor)


class TorchLinear(nn.Module):
    """Linear layer whose weight follows the input dtype and whose bias
    follows the output dtype, with the product rounded before the bias is
    added (``switch_nerf_tpu/models/common.py:35-67``).

    weight is [out, in] (nn.Linear's layout; the JAX kernel is [in, out]).
    """

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = uniform_fan_in((out_features, in_features), in_features,
                                     generator)
        self.bias = (uniform_fan_in((out_features,), in_features, generator)
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Embedding(nn.Module):
    """Appearance table (``OneHotEmbed``): a row gather gives the same
    values as the JAX package's one-hot matmul. Its backward
    (``ops/embedding.py``) sums each table row's gradient rows in ascending
    row order, the same bits on every run (on the card two hand-written
    kernels: a grouping pass over the index range, then the sum), so a
    resumed run repeats an uninterrupted one as JAX's does. Not ``weight[idx]``: a chunk's 32768
    indices hit a handful of rows, and the backward of an index op (an
    index_put accumulate) took 2.7 ms per chunk on the H100, 46 % of a
    Building train step's device time (PERF.md §6)."""

    def __init__(self, num_embeddings: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(num_embeddings, features).normal_(generator=generator))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return embedding(idx, self.weight)


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5) that normalizes in fp32 and returns fp32, as
    flax's LayerNorm does for bf16 input with fp32 parameters."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over the channels of [S, C] (eps 1e-5, flax's layout:
    scale and bias per channel), normalized in fp32 and returned in fp32,
    as LayerNorm."""

    def __init__(self, num_groups: int, features: int):
        super().__init__(num_groups, features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps)


class Dropout(nn.Module):
    """Train-only dropout as flax's: each entry kept with probability
    1 - rate and scaled by 1 / (1 - rate), the rest zeroed. The mask is
    drawn on x's device from the generator the caller passes (a training
    step's, checkpointed with it, so a resumed run draws the masks an
    uninterrupted one draws), through ``keep_mask`` (a hook the parity
    tests replace with JAX's mask)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def keep_mask(self, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        u = torch.rand(x.shape, generator=generator, device=x.device)
        return u >= self.rate

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        # the mask is kept across the remat boundary (remat.py)
        return torch.where(remat.keep(self.keep_mask, x, generator),
                           x / (1.0 - self.rate), torch.zeros_like(x))


def apply_act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "relu":
        return torch.relu(x)
    if name == "none":
        return x
    raise NotImplementedError(f"activation {name!r}")
