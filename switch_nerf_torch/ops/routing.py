"""Top-k switch routing: locations, capacity, auxiliary losses.

Port of ``switch_nerf_tpu/ops/routing.py:33-197``: top-k gates (ties to
the lower expert, as ``jax.lax.top_k``), with or without batch-prioritized
routing (BPR), the load-balance loss and the load-importance loss of
--use_load_importance_loss. Integer plans are bit-equal to the JAX
package's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from switch_nerf_torch import remat

__all__ = [
    "cumsum_sub_one", "compute_sorted_location", "load_balance",
    "load_importance_loss", "compute_capacity", "extract_critical",
    "RoutingPlan",
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


def _norm_cdf(x: torch.Tensor, sigma: float) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / (sigma * math.sqrt(2.0))))


def load_importance_loss(scores_wo_noise: torch.Tensor,
                         topk_logits: torch.Tensor, num_global_experts: int,
                         gate_noise: float, share=None) -> torch.Tensor:
    """(importance + load) / 2 from "Scaling Vision with Sparse MoE", as
    the JAX package computes it: each term var(ddof=1) / (mean^2 + 1e-10)
    of a per-expert sum, the load a normal CDF with sigma = gate_noise / E
    of the noise-free gates less the last top-k logit. gate_noise must be
    positive.

    share (a ``parallel.chunks.ChunkShare``): the tokens are this rank's
    part of a chunk that spans ranks. The per-expert sums are the chunk's
    (``share.sum``) and the loss is this rank's term of the chunk's, its
    holders' count-th, so the terms and their gradients add up to the
    chunk's, as ``extract_critical``'s l_aux does."""
    if gate_noise <= 0:
        raise ValueError(
            "use_load_importance_loss requires --gate_noise > 0 "
            f"(got {gate_noise})")
    scores = scores_wo_noise.float()
    threshold = topk_logits[:, -1:].float()
    sums = torch.stack([
        scores.sum(dim=0),
        _norm_cdf(scores - threshold,
                  gate_noise / num_global_experts).sum(dim=0)])
    if share is not None:
        sums = share.sum(sums)
    imp, load = sums[0], sums[1]
    l_imp = imp.var() / (imp.mean() ** 2 + 1e-10)
    l_load = load.var() / (load.mean() ** 2 + 1e-10)
    loss = (l_imp + l_load) / 2.0
    return loss if share is None else loss / share.holders


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
    """Routing decision for one MoE call.

    indices:   [K, S] int32   expert id per token per k
    locations: [K, S] int32   position in the expert queue (>= capacity: dropped)
    gates:     [K, S] f32     gate score per token per k (renormalised over
                              k when K > 1)
    expert_counts: [E] int32  tokens assigned per expert (pre-drop, summed
                              over k)
    capacity:  int            per-expert slot count
    """
    indices: torch.Tensor
    locations: torch.Tensor
    gates: torch.Tensor
    expert_counts: torch.Tensor
    capacity: int


class _Route(NamedTuple):
    """extract_critical's integer decision (no gradient): the plan's
    indices, locations and counts, the top-1 expert counts over the chunk
    (``ce``, fp32), the chunk's token count and the capacity."""
    indices: torch.Tensor
    locations: torch.Tensor
    expert_counts: torch.Tensor
    ce: torch.Tensor
    total: int
    capacity: int


def _top_k(gates: torch.Tensor, k: int) -> torch.Tensor:
    """[S, k] indices of the k largest gates in descending order, ties to
    the lower index (``jax.lax.top_k``; a stable descending sort keeps
    equal gates in index order)."""
    if k == 1:
        return torch.argmax(gates, dim=1, keepdim=True)
    return torch.sort(gates, dim=1, descending=True, stable=True).indices[
        :, :k]


def _route(gates: torch.Tensor, k: int, capacity_factor: float,
           batch_prioritized_routing: bool, num_experts: int,
           share) -> _Route:
    """The routing decision of `gates` [S, E] (detached): every step of
    extract_critical that carries no gradient, the collective of a shared
    chunk included."""
    s, e = gates.shape
    indices = _top_k(gates, k).t().to(torch.int32)                 # [K, S]
    top = torch.gather(gates, 1, indices[:1].t().long()).t()      # [1, S]
    one_hot = torch.nn.functional.one_hot

    if share is None:
        total, lo, idx_all = s, 0, indices.long()
        importance = -top[0]
    else:
        total, lo = share.total, share.offset
        both = share.gather(torch.cat([indices.float(), top]))     # [K+1, T]
        idx_all = both[:k].long()
        importance = -both[k]
    masks = one_hot(idx_all, e).to(torch.int32)                    # [K, T, E]
    ce = torch.sum(masks[0].float(), dim=0)

    # the k-th choices queue behind every token's earlier choices
    locations = []
    for j in range(k):
        if batch_prioritized_routing:
            loc = compute_sorted_location(masks[j], importance)
        else:
            loc = cumsum_sub_one(masks[j])
        if j:
            loc = loc + torch.sum(masks[:j], dim=(0, 1))[None]
        locations.append(torch.sum(loc * masks[j], dim=1).to(torch.int32))
    locations = torch.stack(locations)[:, lo:lo + s]
    own = masks if share is None else one_hot(indices.long(), e)
    counts = torch.sum(own, dim=(0, 1)).to(torch.int32)
    capacity = compute_capacity(total, num_experts, k, capacity_factor)
    return _Route(indices, locations, counts, ce, total, capacity)


def extract_critical(gates: torch.Tensor, top_k: int,
                     capacity_factor: float = 1.0,
                     batch_prioritized_routing: bool = False,
                     num_experts: Optional[int] = None, share=None):
    """Top-k routing decision + load-balance loss.

    gates: [S, E] softmax probabilities (fp32). Returns (RoutingPlan, l_aux).
    The k-th choice's locations follow every token's earlier choices
    (offset by their counts), the counts sum over k, and with K > 1 the
    gates are renormalised over k (clamped at float32's eps), as in JAX.
    l_aux is the top-1 load balance.

    share (a ``parallel.chunks.ChunkShare``): these S tokens are this
    rank's part of a chunk of ``share.total`` tokens that spans ranks. The
    holders exchange every token's K experts and top gate value, so each
    routes the whole chunk as JAX does (capacity from its token count, the
    batch-prioritized order over all of it) and keeps its own tokens'
    locations. l_aux is this rank's term of the chunk's: its own gates'
    sums against the chunk's counts over the chunk's S^2, so the holders'
    terms (and their gradients) add up to the chunk's.

    The integer decision (``_route``) is kept across the remat boundary
    as ``moe_plan`` (``remat.py``): a recompute takes it as the forward
    made it and only gathers the gates at its experts again.
    """
    s, e = gates.shape
    num_experts = num_experts or e
    k = min(top_k, e)
    route = remat.keep(_route, gates.detach(), k, capacity_factor,
                       batch_prioritized_routing, num_experts, share,
                       name="moe_plan")
    gates_k = torch.gather(gates, 1, route.indices.t().long()).t().float()
    me = torch.sum(gates.float(), dim=0)
    l_aux = torch.sum(me * route.ce) * (
        num_experts / float(route.total * route.total))
    if k > 1:
        gates_k = gates_k / torch.clamp(
            torch.sum(gates_k, dim=0), min=torch.finfo(torch.float32).eps)
    plan = RoutingPlan(indices=route.indices, locations=route.locations,
                       gates=gates_k, expert_counts=route.expert_counts,
                       capacity=route.capacity)
    return plan, l_aux
