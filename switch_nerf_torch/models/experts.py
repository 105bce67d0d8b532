"""Stacked expert MLPs: the FLOP core of the MoE layer.

Port of ``switch_nerf_tpu/models/experts.py:28-103`` (ExpertMLP, padded,
ragged and fused-dispatch forms). Parameters w{i} [E, M, M] and b{i}
[E, 1, M] keep the JAX layout. On the card every form runs hand-written
kernels, forward and backward (``ops/expert_kernel`` K1/K2,
``ops/ragged_chain`` K1R/K2R, ``ops/fused_dispatch`` K3/K4); on the CPU
their plain versions.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from switch_nerf_torch.models.common import uniform_fan_in
from switch_nerf_torch.ops.expert_kernel import expert_mlp_chain
from switch_nerf_torch.ops.fused_dispatch import fused_dispatch_chain
from switch_nerf_torch.ops.ragged_chain import ragged_chain


class ExpertMLP(nn.Module):
    def __init__(self, model_dim: int, num_experts: int, layer_num: int,
                 skips: Optional[Sequence[int]] = None,
                 init_factor: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        m = model_dim
        self.layer_num = layer_num
        self.skips: Tuple[int, ...] = tuple(skips or ())
        for i in range(layer_num):
            self.register_parameter(f"w{i}", uniform_fan_in(
                (num_experts, m, m), m, generator, init_factor))
            self.register_parameter(f"b{i}", uniform_fan_in(
                (num_experts, 1, m), m, generator, init_factor))

    def stacked(self, dtype: torch.dtype):
        """([L, E, M, M], [L, E, 1, M]) in the compute dtype."""
        ws = torch.stack([getattr(self, f"w{i}").to(dtype)
                          for i in range(self.layer_num)])
        bs = torch.stack([getattr(self, f"b{i}").to(dtype)
                          for i in range(self.layer_num)])
        return ws, bs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Padded form: x [E, C, M] -> [E, C, M]."""
        ws, bs = self.stacked(x.dtype)
        return expert_mlp_chain(x, ws, bs, self.skips)

    def ragged(self, x: torch.Tensor, counts: torch.Tensor,
               row_expert: torch.Tensor) -> torch.Tensor:
        """Ragged form: x [N, M] sorted by expert, counts [E] int32 on x's
        device -> [N, M]. row_expert [N] (each row's expert) is the JAX
        signature's; the kernel finds each expert's rows from the counts,
        so it is not read."""
        del row_expert
        ws, bs = self.stacked(x.dtype)
        return ragged_chain(x, counts, ws, bs, self.skips)

    def fused_dispatch(self, tokens_ext: torch.Tensor, stt_eff: torch.Tensor,
                       slot: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
        """``self(dispatch(tokens))`` without the dispatch buffer; slot and
        kept (token->slot map) drive d(tokens) in the backward."""
        ws, bs = self.stacked(tokens_ext.dtype)
        return fused_dispatch_chain(tokens_ext, stt_eff, ws, bs, slot, kept,
                                    self.skips)
