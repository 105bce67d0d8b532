"""Top-1 switch routing: locations, capacity, load-balance loss.

Port of ``switch_nerf_tpu/ops/routing.py:33-197`` for top-1 gates, with or
without batch-prioritized routing (BPR). Integer plans are bit-equal to the
JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = [
    "cumsum_sub_one", "compute_sorted_location", "load_balance",
    "compute_capacity", "extract_critical", "RoutingPlan",
]


def cumsum_sub_one(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along tokens minus one; [S, E] int32.

    Scanned along the contiguous axis of the [E, S] transpose: PyTorch's
    CUDA scan down the outer dim of an [S, E] tensor with few columns gives
    each column one thread (5.1 ms for [32768, 8] on the H100, half of an
    eval request). Integer sums, so the result is the same either way.
    """
    rows = mask.t().to(torch.int32).contiguous()
    return (torch.cumsum(rows, dim=1, dtype=torch.int32) - 1).t()


def compute_sorted_location(mask: torch.Tensor,
                            importance_scores: torch.Tensor) -> torch.Tensor:
    """Batch-prioritized routing: positions assigned in importance order.

    importance_scores: [S]; lower = more important (the caller passes
    -max_gate). JAX sorts on two keys, importance first and then token
    position. A stable sort over importance alone gives the same order here
    only because the tokens already come in position order, so equal
    importances keep their position order. (The scores are negated softmax
    maxima, never zero, so JAX's ordering of -0.0 before 0.0 never matters.)
    """
    s, e = mask.shape
    expert_of = torch.argmax(mask, dim=1)                          # [S]
    order = torch.sort(importance_scores, stable=True).indices     # [S]
    sorted_mask = torch.nn.functional.one_hot(expert_of[order], e)
    loc_sorted = torch.sum(cumsum_sub_one(sorted_mask) * sorted_mask,
                           dim=1).to(torch.int32)                  # [S]
    loc = torch.empty_like(loc_sorted)
    loc[order] = loc_sorted                                        # back to token order
    return loc[:, None] * mask.to(torch.int32)


def load_balance(gates: torch.Tensor, mask1: torch.Tensor,
                 num_global_experts: int) -> torch.Tensor:
    """Switch load-balance loss: E * sum(me * ce) / S^2 (fp32)."""
    s = gates.shape[0]
    me = torch.sum(gates.float(), dim=0)
    ce = torch.sum(mask1.float(), dim=0)
    return torch.sum(me * ce) * (num_global_experts / float(s * s))


def compute_capacity(num_tokens: int, num_experts: int, top_k: int,
                     capacity_factor: float) -> int:
    """capacity = top_k * int(cf * ceil(S / E)); cf <= 0 resolves statically
    to S * top_k (capped by -cf when negative), as in the JAX package."""
    if capacity_factor > 0:
        return top_k * int(capacity_factor
                           * ((num_tokens + num_experts - 1) // num_experts))
    cap = num_tokens * top_k
    if capacity_factor < 0:
        cap = min(cap, top_k * int(-capacity_factor * (
            (num_tokens + num_experts - 1) // num_experts)))
    return max(cap, 1)


class RoutingPlan(NamedTuple):
    """Routing decision for one MoE call (K = 1).

    indices:   [K, S] int32   expert id per token
    locations: [K, S] int32   position in the expert queue (>= capacity: dropped)
    gates:     [K, S] f32     gate score per token
    expert_counts: [E] int32  tokens assigned per expert (pre-drop)
    capacity:  int            per-expert slot count
    """
    indices: torch.Tensor
    locations: torch.Tensor
    gates: torch.Tensor
    expert_counts: torch.Tensor
    capacity: int


def extract_critical(gates: torch.Tensor, top_k: int,
                     capacity_factor: float = 1.0,
                     batch_prioritized_routing: bool = False,
                     num_experts: Optional[int] = None, share=None):
    """Top-1 routing decision + load-balance loss.

    gates: [S, E] softmax probabilities (fp32). Returns (RoutingPlan, l_aux).
    argmax ties resolve to the first index, as in JAX.

    share (a ``parallel.chunks.ChunkShare``): these S tokens are this
    rank's part of a chunk of ``share.total`` tokens that spans ranks. The
    holders exchange every token's expert and gate value, so each routes
    the whole chunk as JAX does (capacity from its token count, the
    batch-prioritized order over all of it) and keeps its own tokens'
    locations. l_aux is this rank's term of the chunk's: its own gates'
    sums against the chunk's counts over the chunk's S^2, so the holders'
    terms (and their gradients) add up to the chunk's.
    """
    if top_k != 1:
        raise NotImplementedError("the port routes top-1 only (k > 1 waits)")
    s, e = gates.shape
    num_experts = num_experts or e
    topk_idx = torch.argmax(gates, dim=1, keepdim=True)            # [S, 1]
    topk_vals = torch.gather(gates, 1, topk_idx)                   # [S, 1]
    indices = topk_idx.t().to(torch.int32)                         # [1, S]
    mask = torch.nn.functional.one_hot(indices[0].long(), e).to(torch.int32)
    gates_k = topk_vals.t().float()                                # [1, S]

    if share is None:
        total, lo, mask_all = s, 0, mask
        importance = -torch.max(gates, dim=1).values
        l_aux = load_balance(gates, mask, num_experts)
    else:
        total, lo = share.total, share.offset
        both = share.gather(torch.stack([indices[0].float(),
                                         gates_k[0].detach()]))    # [2, T]
        mask_all = torch.nn.functional.one_hot(both[0].long(), e).to(
            torch.int32)
        importance = -both[1]
        me = torch.sum(gates.float(), dim=0)
        ce = torch.sum(mask_all.float(), dim=0)
        l_aux = torch.sum(me * ce) * (num_experts / float(total * total))

    if batch_prioritized_routing:
        loc = compute_sorted_location(mask_all, importance)
    else:
        loc = cumsum_sub_one(mask_all)
    locations = torch.sum(loc * mask_all, dim=1).to(torch.int32)
    locations = locations[lo:lo + s][None]
    counts = torch.sum(mask, dim=0).to(torch.int32)

    capacity = compute_capacity(total, num_experts, top_k, capacity_factor)
    plan = RoutingPlan(indices=indices, locations=locations, gates=gates_k,
                       expert_counts=counts, capacity=capacity)
    return plan, l_aux
