"""Switch-gated Mixture-of-Experts layer, top-k.

Port of ``switch_nerf_tpu/models/moe.py:39-284`` for eval and training:
fp32 gate, gate noise (--gate_noise > 0, train mode only; JAX's normal
noise has no flag that sets it), ``extract_critical`` (top-k, with BPR),
the load-balance ``l_aux`` or, with --use_load_importance_loss, the
load-importance loss (the load balance then in ``extras["balance_loss"]``
with --compute_balance_loss), ``return_gates`` and ``return_gate_logits``,
``_padded_path`` (capacity-padded dispatch, including the fused
dispatch+chain branch behind ``SWITCH_NERF_FUSED_DISPATCH=1``, top-1
ExpertMLP only) and ``_nodrop_path`` (sort by expert, the ragged chain
K1R/K2R, inverse permutation; no token dropped), the residual MoE
(--moe_use_residual: a one-expert ``residual_expert`` blended by a
softmax ``coefficient``) and the ffn experts (--moe_expert_type ffn,
``models/experts.FFNExperts``). The dispatch mode follows ``train`` as
JAX's follows ``deterministic`` (``moe.py:127``). Under expert
parallelism the gate routes over all E experts and the experts module
holds this rank's E_loc: the padded path exchanges the dispatch buffer
with the experts' owners around the chain, as JAX does
(``moe.py:201-216``), and the no-drop path runs the whole model
(``models/experts.py``); the residual expert is replicated, as in JAX.

Gate noise is drawn from the generator the caller passes (a training
step's: ``render/rendering.py`` gives the order of its draws), through
``noise`` (a hook the parity tests replace with JAX's draw).

Under --remat (``remat.py``) a recompute of the layer takes the gate
noise, the routing plan and the padded path's dispatch buffer (or, fused,
the plan alone) as the forward made them, and runs the rest again: the
gate, the gather of the gates at the kept experts, the expert chain and
the combine. The no-drop path keeps nothing of its own, as in JAX: its
sort by expert, ragged chain and inverse permutation run again.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
from torch import nn

from switch_nerf_torch import remat
from switch_nerf_torch.models.common import TorchLinear
from switch_nerf_torch.models.experts import ExpertMLP, FFNExperts
from switch_nerf_torch.ops.dispatch import (
    DispatchPlan, build_dispatch_plan, combine, dispatch)
from switch_nerf_torch.ops.fused_dispatch import (
    fused_slot_map, fused_supported)
from switch_nerf_torch.ops.routing import (extract_critical,
                                           load_importance_loss)
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
                 use_load_importance_loss: bool = False,
                 compute_balance_loss: bool = False,
                 use_residual: bool = False,
                 return_gate_logits: bool = False,
                 train_dispatch: str = "padded",
                 eval_dispatch: str = "padded",
                 expert_type: str = "expertmlp", ffn_hidden_size: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gate_noise = gate_noise
        self.use_load_importance_loss = use_load_importance_loss
        self.compute_balance_loss = compute_balance_loss
        self.use_residual = use_residual
        self.return_gate_logits = return_gate_logits
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
        if expert_type == "ffn":
            self.experts = FFNExperts(model_dim, num_experts,
                                      ffn_hidden_size or model_dim,
                                      generator=generator)
        else:
            self.experts = ExpertMLP(model_dim, num_experts, layer_num,
                                     skips, init_factor, generator=generator)
        if use_residual:
            self.residual_expert = ExpertMLP(model_dim, 1, layer_num, skips,
                                             init_factor, generator=generator)
            self.coefficient = TorchLinear(model_dim, 2, generator=generator)

    def noise(self, logits: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        """N(0, 1) shaped like the gate logits, from `generator` (the
        default generator of the logits' device when None)."""
        return torch.randn(logits.shape, generator=generator,
                           dtype=logits.dtype, device=logits.device)

    def forward(self, x: torch.Tensor, gate_input: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: [S, M]; gate_input: [S, gate_dim] or None. In train mode
        gate noise (--gate_noise > 0) comes from `generator`.

        Returns (y [S, M] in x's dtype, l_aux fp32 scalar, extras dict).
        """
        e = self.num_experts
        gin = gate_input if gate_input is not None else x
        logits = self.wg(gin.float() if self.fp32_gate else gin)
        noisy = logits
        if self.gate_noise > 0 and train:
            # the draw is kept across the remat boundary (remat.py)
            noisy = logits + self.gate_noise * remat.keep(
                self.noise, logits, generator) / e
        gates = torch.softmax(noisy.float(), dim=1)
        # a data-parallel chunk that spans ranks routes over all of its
        # tokens (parallel/chunks.py); None: over these
        share = current_share()
        plan, l_aux = extract_critical(gates, self.top_k,
                                       self.capacity_factor,
                                       self.batch_prioritized_routing,
                                       share=share)
        extras = {}
        if self.use_load_importance_loss:
            balance = l_aux
            topk_logits = torch.gather(noisy.float(), 1,
                                       plan.indices.t().long())
            l_aux = load_importance_loss(torch.softmax(logits.float(), dim=1),
                                         topk_logits, e, self.gate_noise,
                                         share=share)
            if self.compute_balance_loss:
                extras["balance_loss"] = balance
        mode = self.train_dispatch if train else self.eval_dispatch
        if mode == "nodrop":
            y = self._nodrop_path(x, plan)
        else:
            y = self._padded_path(x, plan)
        y = y.to(x.dtype)
        if self.use_residual:
            res = self.residual_expert(x[None])[0]
            coef = torch.softmax(self.coefficient(x.float()), dim=-1).to(
                x.dtype)
            y = y * coef[..., 0:1] + res * coef[..., 1:]
        if self.return_gates:
            extras["gates"] = plan.indices.t()                     # [S, K]
        if self.return_gate_logits:
            extras["gate_logits"] = logits
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
        card's kernel takes (``ops/fused_dispatch.fused_supported``),
        ExpertMLP experts and no expert parallelism (JAX
        ``moe.py:236-237``)."""
        if os.environ.get("SWITCH_NERF_FUSED_DISPATCH", "0") != "1":
            return False
        if self.experts.ep is not None or isinstance(self.experts,
                                                     FFNExperts):
            return False
        return (self.top_k == 1 and (self.is_postscore or self.no_score)
                and fused_supported(x.shape, dp.num_experts, dp.capacity,
                                    self.layer_num))
