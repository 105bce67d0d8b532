"""Switch-gated Mixture-of-Experts layer, top-1.

Port of ``switch_nerf_tpu/models/moe.py:39-284`` for eval and training:
fp32 gate, ``extract_critical`` (with BPR), the load-balance ``l_aux``,
``return_gates``, ``_padded_path`` (capacity-padded dispatch, including the
fused dispatch+chain branch behind ``SWITCH_NERF_FUSED_DISPATCH=1``) and
``_nodrop_path`` (sort by expert, the ragged chain K1R/K2R, inverse
permutation; no token dropped). The dispatch mode follows ``train`` as
JAX's follows ``deterministic`` (``moe.py:127``). Under expert
parallelism the gate routes over all E experts and ``ExpertMLP`` holds
this rank's E_loc: the padded path exchanges the dispatch buffer with the
experts' owners around the chain, as JAX does (``moe.py:201-216``), and
the no-drop path runs the whole model (``models/experts.py``). Residual
MoE, gate noise (a training-only draw, off in every published command;
the JAX layer's normal noise has no flag that sets it) and the
load-importance loss wait for later slices.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
from torch import nn

from switch_nerf_torch.models.common import TorchLinear
from switch_nerf_torch.models.experts import ExpertMLP
from switch_nerf_torch.ops.dispatch import (
    DispatchPlan, build_dispatch_plan, combine, dispatch)
from switch_nerf_torch.ops.fused_dispatch import (
    fused_slot_map, fused_supported)
from switch_nerf_torch.ops.routing import extract_critical
from switch_nerf_torch.ops.sorting import sort_with_payloads
from switch_nerf_torch.parallel.chunks import current_share


class MoELayer(nn.Module):
    def __init__(self, model_dim: int, num_experts: int, layer_num: int = 1,
                 skips: Optional[Sequence[int]] = None,
                 init_factor: float = 1.0, top_k: int = 1,
                 capacity_factor: float = 1.0,
                 batch_prioritized_routing: bool = False,
                 fp32_gate: bool = True, gate_dim: Optional[int] = None,
                 is_postscore: bool = True, no_score: bool = False,
                 return_gates: bool = False, gate_noise: float = -1.0,
                 train_dispatch: str = "padded",
                 eval_dispatch: str = "padded",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if top_k != 1:
            raise NotImplementedError("the port routes top-1 only")
        self.gate_noise = gate_noise
        self.train_dispatch = train_dispatch
        self.eval_dispatch = eval_dispatch
        self.model_dim = model_dim
        self.num_experts = num_experts
        self.layer_num = layer_num
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.batch_prioritized_routing = batch_prioritized_routing
        self.fp32_gate = fp32_gate
        self.is_postscore = is_postscore
        self.no_score = no_score
        self.return_gates = return_gates
        self.wg = TorchLinear(gate_dim or model_dim, num_experts,
                              use_bias=False, generator=generator)
        self.experts = ExpertMLP(model_dim, num_experts, layer_num, skips,
                                 init_factor, generator=generator)

    def check_supported(self, train: bool) -> None:
        """Raise on what the port does not run yet in this mode."""
        if train and self.gate_noise > 0:
            raise NotImplementedError(
                "gate noise waits for a later slice of the port (off in "
                "every published Building command)")

    def forward(self, x: torch.Tensor, gate_input: Optional[torch.Tensor] = None,
                train: bool = False):
        """x: [S, M]; gate_input: [S, gate_dim] or None.

        Returns (y [S, M] in x's dtype, l_aux fp32 scalar, extras dict).
        """
        self.check_supported(train)
        gin = gate_input if gate_input is not None else x
        logits = self.wg(gin.float() if self.fp32_gate else gin)
        gates = torch.softmax(logits.float(), dim=1)
        # a data-parallel chunk that spans ranks routes over all of its
        # tokens (parallel/chunks.py); None: over these
        plan, l_aux = extract_critical(gates, self.top_k,
                                       self.capacity_factor,
                                       self.batch_prioritized_routing,
                                       share=current_share())
        mode = self.train_dispatch if train else self.eval_dispatch
        if mode == "nodrop":
            y = self._nodrop_path(x, plan)
        else:
            y = self._padded_path(x, plan)
        y = y.to(x.dtype)
        extras = {}
        if self.return_gates:
            extras["gates"] = plan.indices.t()                     # [S, K]
        return y, l_aux, extras

    def _padded_path(self, x: torch.Tensor, plan) -> torch.Tensor:
        dp = build_dispatch_plan(plan, self.num_experts)
        if self._use_fused_dispatch(x, dp):
            # fold the dispatch gather into the chain kernel: the [E, C, M]
            # buffer is never built; empty slots read the appended zero row
            # The JAX package pads to a multiple of 8 rows for Mosaic's
            # aligned loads; the card's kernels load any row, so one row.
            s, m = x.shape
            tokens_ext = torch.cat([x, x.new_zeros((1, m))], dim=0)
            ec = dp.num_experts * dp.capacity
            slot_ext = torch.cat([dp.slot[0], dp.slot.new_full((1,), ec)])
            kept_ext = torch.cat([dp.kept[0], dp.kept.new_zeros((1,))])
            expert_out = self.experts.fused_dispatch(
                tokens_ext,
                fused_slot_map(dp.slot_to_token[0], dp.filled[0], s),
                slot_ext, kept_ext)
        else:
            expert_out = self.experts(dispatch(
                x, dp, is_postscore=self.is_postscore,
                no_score=self.no_score))                           # [E, C, M]
        return combine(expert_out, dp, is_postscore=self.is_postscore,
                       no_score=self.no_score)

    def _nodrop_path(self, x: torch.Tensor, plan) -> torch.Tensor:
        """Sort by expert + the ragged chain; no token dropped (JAX
        ``moe.py:241-284``). The stable sort carries each row's token and
        gate; x[row_token] is scaled by the gate here unless postscore or
        no_score; the inverse permutation (a second payload sort) gathers
        the expert outputs back in their own dtype, cast to fp32 for the
        gate multiply and the sum over k. The counts stay on the device:
        no host sync. Gradients flow through the gathers."""
        k, s = plan.indices.shape
        flat_expert = plan.indices.reshape(-1).to(torch.int32)
        gates_flat = plan.gates.reshape(-1).float()
        iota = torch.arange(k * s, dtype=torch.int32, device=x.device)
        row_expert, order, sorted_gates = sort_with_payloads(
            flat_expert, iota, gates_flat)
        row_token = (order % s).long()
        xs = x[row_token]                                          # [K*S, M]
        if not (self.is_postscore or self.no_score):
            xs = xs * sorted_gates[:, None].to(xs.dtype)
        ys = self.experts.ragged(xs, plan.expert_counts, row_expert)
        _, inv = sort_with_payloads(order, iota)
        rows = ys[inv.long()].float().reshape(k, s, -1)
        if self.no_score or not self.is_postscore:
            return rows.sum(dim=0)
        return torch.sum(rows * plan.gates[..., None], dim=0)

    def _use_fused_dispatch(self, x: torch.Tensor, dp: DispatchPlan) -> bool:
        """Opt-in (SWITCH_NERF_FUSED_DISPATCH=1), read at each call as the
        JAX package does: top-1, postscore or no_score, at shapes the
        card's kernel takes (``ops/fused_dispatch.fused_supported``), and
        no expert parallelism (JAX ``moe.py:236-237``); JAX's ExpertMLP
        condition always holds in the port."""
        if os.environ.get("SWITCH_NERF_FUSED_DISPATCH", "0") != "1":
            return False
        if self.experts.ep is not None:
            return False
        return (self.top_k == 1 and (self.is_postscore or self.no_score)
                and fused_supported(x.shape, dp.num_experts, dp.capacity,
                                    self.layer_num))
