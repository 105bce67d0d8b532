"""Capacity-padded MoE token dispatch/combine.

Port of ``switch_nerf_tpu/ops/dispatch.py:50-304``: the slot indices are
scattered into a slot->token map, and token rows are then GATHERED into the
[E*C, M] buffer. Dropped tokens never reach a slot; empty slots stay zero.
Both directions are ``torch.autograd.Function``s whose backwards mirror the
JAX custom VJPs (``_dispatch_bwd`` :204-220, ``_combine_bwd`` :247-270),
casts included: each transpose is a gather over the inverse map, not a
scatter-add, and the gate gradient is an fp32-accumulated row dot masked by
``kept``. The einsum oracles are kept for the tests.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from switch_nerf_torch import remat
from switch_nerf_torch.ops.routing import RoutingPlan

__all__ = [
    "DispatchPlan", "build_dispatch_plan", "dispatch", "combine",
    "dispatch_einsum_oracle", "combine_einsum_oracle",
]


class DispatchPlan(NamedTuple):
    """Index sets for one dispatch/combine pair.

    slot:          [K, S] int64  flat slot e*C+loc per (k, token); ==E*C if dropped
    kept:          [K, S] bool   location < capacity
    slot_to_token: [K, E*C] int64  token feeding each slot (0 where empty)
    filled:        [K, E*C] bool  slot occupancy
    gates:         [K, S] f32    gate scores (from the routing plan)
    num_experts:   int
    capacity:      int
    """
    slot: torch.Tensor
    kept: torch.Tensor
    slot_to_token: torch.Tensor
    filled: torch.Tensor
    gates: torch.Tensor
    num_experts: int
    capacity: int


def build_dispatch_plan(plan: RoutingPlan, num_experts: int) -> DispatchPlan:
    """The slot maps of `plan`; kept across the remat boundary as
    ``moe_plan`` (``remat.py``), the gates as the plan has them."""
    cap = int(plan.capacity)
    slot, kept, slot_to_token, filled = remat.keep(
        _slot_maps, plan.indices, plan.locations, cap, num_experts,
        name="moe_plan")
    return DispatchPlan(slot=slot, kept=kept, slot_to_token=slot_to_token,
                        filled=filled, gates=plan.gates,
                        num_experts=num_experts, capacity=cap)


def _slot_maps(indices: torch.Tensor, locations: torch.Tensor, cap: int,
               num_experts: int):
    k, s = indices.shape
    ec = num_experts * cap
    dev = indices.device

    kept = locations < cap                                         # [K, S]
    slot = torch.where(kept, indices.long() * cap + locations.long(),
                       torch.full_like(indices, ec, dtype=torch.long))
    # scatter over ec + 1 entries, then cut the last: every dropped token
    # writes the spare entry ec (JAX's mode="drop" target), so only kept
    # slots survive. Kept slots are unique, so the scatter is exact.
    token_ids = torch.arange(s, device=dev).expand(k, s)
    slot_to_token = torch.full((k, ec + 1), s, dtype=torch.long, device=dev)
    slot_to_token.scatter_(1, slot, token_ids)
    slot_to_token = slot_to_token[:, :ec]
    filled = slot_to_token < s
    slot_to_token = torch.where(filled, slot_to_token,
                                torch.zeros_like(slot_to_token))
    return slot, kept, slot_to_token, filled


def dispatch(tokens: torch.Tensor, dp: DispatchPlan, *,
             is_postscore: bool = True, no_score: bool = False) -> torch.Tensor:
    """tokens [S, M] -> dispatched [E, C, M] (K summed into slots)."""
    prescore = not (is_postscore or no_score)
    out = _DispatchFn.apply(tokens, dp.gates, dp.slot, dp.kept,
                            dp.slot_to_token, dp.filled, prescore)
    return out.reshape(dp.num_experts, dp.capacity, tokens.shape[-1])


def combine(expert_output: torch.Tensor, dp: DispatchPlan, *,
            is_postscore: bool = True, no_score: bool = False) -> torch.Tensor:
    """expert_output [E, C, M] -> combined [S, M] fp32.

    Rows are gathered in the expert dtype; the gate scale is applied with an
    fp32 sum, as in the JAX package.
    """
    postscore = is_postscore and not no_score
    m = expert_output.shape[-1]
    flat = expert_output.reshape(dp.num_experts * dp.capacity, m)
    return _CombineFn.apply(flat, dp.gates, dp.slot, dp.kept,
                            dp.slot_to_token, dp.filled, postscore)


def _gather_rows(flat: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """[K, S, M] rows of flat [E*C, M] by slot, zeros where slot == E*C."""
    flat_ext = torch.cat([flat, flat.new_zeros((1, flat.shape[-1]))], dim=0)
    return flat_ext[slot.reshape(-1)].reshape(*slot.shape, flat.shape[-1])


def _row_dot(a: torch.Tensor, b: torch.Tensor, kept: torch.Tensor):
    """einsum("ksm,sm->ks") accumulated in fp32, masked by kept."""
    return torch.einsum("ksm,sm->ks", a.float(), b.float()) * kept


def _gather_slots(tokens, gates, stt, filled, prescore) -> torch.Tensor:
    """[E*C, M]: each slot's token row (K summed), zero where empty."""
    out = None
    for k in range(stt.shape[0]):
        src = tokens
        if prescore:
            # the gate multiplies on the token side before the gather
            src = tokens * gates[k, :, None].to(tokens.dtype)
        g = src[stt[k]] * filled[k][:, None].to(tokens.dtype)
        out = g if out is None else out + g
    return out


class _DispatchFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, gates, slot, kept, stt, filled, prescore):
        ctx.prescore = prescore
        ctx.save_for_backward(tokens, gates, slot, kept)
        # kept across the remat boundary (remat.py): a recompute returns
        # the forward's buffer, and the backward stays the scatter
        return remat.keep(_gather_slots, tokens, gates, stt, filled,
                          prescore, name="moe_dispatched")     # [E*C, M]

    @staticmethod
    def backward(ctx, g):
        tokens, gates, slot, kept = ctx.saved_tensors
        rows = _gather_rows(g, slot)                             # [K, S, M]
        keptf = kept.to(g.dtype)
        d_gates = None
        if ctx.prescore:
            d_tokens = torch.sum(
                rows * (keptf * gates.to(g.dtype))[..., None], dim=0)
            d_gates = _row_dot(rows, tokens, kept).to(gates.dtype)
        else:
            d_tokens = torch.sum(rows * keptf[..., None], dim=0)
        return (d_tokens.to(tokens.dtype), d_gates, None, None, None, None,
                None)


class _CombineFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, gates, slot, kept, stt, filled, postscore):
        ctx.postscore = postscore
        ctx.save_for_backward(flat, gates, slot, kept, stt, filled)
        rows = _gather_rows(flat, slot)                          # [K, S, M]
        scale = kept.float()
        if postscore:
            scale = scale * gates.float()
        return torch.sum(rows.float() * scale[..., None], dim=0)

    @staticmethod
    def backward(ctx, d_y):
        flat, gates, slot, kept, stt, filled = ctx.saved_tensors
        # gather d_y by slot->token in the expert dtype, the gate multiplied
        # on the token side (no per-slot gate gather)
        d_y_lo = d_y.to(flat.dtype)
        d_flat = None
        for k in range(stt.shape[0]):
            src = d_y_lo
            if ctx.postscore:
                src = src * gates[k, :, None].to(flat.dtype)
            g = src[stt[k]] * filled[k][:, None].to(flat.dtype)
            d_flat = g if d_flat is None else d_flat + g
        d_gates = None
        if ctx.postscore:
            d_gates = _row_dot(_gather_rows(flat, slot), d_y_lo,
                               kept).to(gates.dtype)
        return (d_flat.to(flat.dtype), d_gates, None, None, None, None,
                None)


def _dispatch_mask(dp: DispatchPlan, dtype) -> torch.Tensor:
    """[K, S, E, C] one-hot dispatch tensor (dropped rows all zero)."""
    e, c = dp.num_experts, dp.capacity
    oh = torch.nn.functional.one_hot(dp.slot, e * c + 1)[..., :e * c]
    return oh.to(dtype).reshape(*dp.slot.shape, e, c)


def dispatch_einsum_oracle(tokens: torch.Tensor, dp: DispatchPlan, *,
                           is_postscore: bool = True,
                           no_score: bool = False) -> torch.Tensor:
    mask = _dispatch_mask(dp, tokens.dtype)
    if not (is_postscore or no_score):
        mask = mask * dp.gates.to(tokens.dtype)[..., None, None]
    return torch.einsum("ksec,sm->ecm", mask, tokens)


def combine_einsum_oracle(expert_output: torch.Tensor, dp: DispatchPlan, *,
                          is_postscore: bool = True,
                          no_score: bool = False) -> torch.Tensor:
    mask = _dispatch_mask(dp, expert_output.dtype)
    if is_postscore and not no_score:
        mask = mask * dp.gates.to(expert_output.dtype)[..., None, None]
    return torch.einsum("ksec,ecm->sm", mask, expert_output)
