"""The masked MoE layer: every expert on every token, one-hot select.

Port of ``switch_nerf_tpu/models/moe_reference.py:27-65``, the numerics
oracle of the MoE layer: fp32 gate softmax, top-1 argmax, each expert's
chain on all S tokens ([E, S, M] through ``ExpertMLP``: K1 on the card),
the top-1 expert's output kept and scaled by its gate (postscore) or the
input scaled first (prescore); no token dropped. O(E S M^2) work: a test
oracle, on no path of the port.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from switch_nerf_torch.models.common import TorchLinear
from switch_nerf_torch.models.experts import ExpertMLP
from switch_nerf_torch.ops.routing import load_balance

__all__ = ["MaskedMoELayer"]


class MaskedMoELayer(nn.Module):
    def __init__(self, model_dim: int, num_experts: int, layer_num: int = 1,
                 skips: Optional[Sequence[int]] = None,
                 init_factor: float = 1.0, fp32_gate: bool = True,
                 gate_dim: Optional[int] = None, is_postscore: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_experts = num_experts
        self.fp32_gate = fp32_gate
        self.is_postscore = is_postscore
        self.wg = TorchLinear(gate_dim or model_dim, num_experts,
                              use_bias=False, generator=generator)
        self.experts = ExpertMLP(model_dim, num_experts, layer_num, skips,
                                 init_factor, generator=generator)

    def forward(self, x: torch.Tensor,
                gate_input: Optional[torch.Tensor] = None):
        """x [S, M] -> (y [S, M] in x's dtype, l_aux, {})."""
        s, m = x.shape
        e = self.num_experts
        gin = gate_input if gate_input is not None else x
        logits = self.wg(gin.float() if self.fp32_gate else gin)
        gates = torch.softmax(logits.float(), dim=1)
        top1 = torch.argmax(gates, dim=1)
        mask = torch.nn.functional.one_hot(top1, e).float()        # [S, E]
        score = torch.max(gates, dim=1, keepdim=True).values        # [S, 1]
        l_aux = load_balance(gates, mask, e)
        xin = x if self.is_postscore else x * score.to(x.dtype)
        y_all = self.experts(xin[None].expand(e, s, m).contiguous())
        y = torch.einsum("esm,se->sm", y_all.float(), mask)
        if self.is_postscore:
            y = y * score
        return y.to(x.dtype), l_aux, {}
