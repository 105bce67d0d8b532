"""Stacked expert MLPs: the FLOP core of the MoE layer.

Port of ``switch_nerf_tpu/models/experts.py:28-147`` (ExpertMLP, padded,
ragged and fused-dispatch forms, and the 2-layer ``FFNExperts`` of
--moe_expert_type ffn). Parameters w{i} [E, M, M] and b{i} [E, 1, M]
(ffn: w1 [E, M, H], b1 [E, 1, H], w2 [E, H, M], b2 [E, 1, M]) keep the
JAX layout. On the card every form runs hand-written
kernels, forward and backward (``ops/expert_kernel`` K1/K2,
``ops/ragged_chain`` K1R/K2R, ``ops/fused_dispatch`` K3/K4); on the CPU
their plain versions.

Under expert parallelism (``localize``) a rank's ExpertMLP holds its
block of E_loc experts, each parameter tagged with the mesh
(``expert_mesh``). The padded form then runs on the owners through the
token exchange (``parallel/experts.chain``: K1 and K2 on
[E_loc, E_axis C, M]); the other forms run the whole model: inside
``gathered`` (eval) on weights gathered once, otherwise (no-drop
training) on weights gathered at each call, whose gradients go back to
their owners (``parallel/experts.WholeExperts``).

Under expert weight parallelism (``localize`` with
--expert_weight_parallel) each parameter also keeps its column block of
the last dimension, tagged ``weight_mesh``; a training pass runs inside
``hold_for_pass``, which gathers the blocks once (``parallel/weights``)
and every MoE call of the pass takes its weights from that copy, first
exchanging tokens with the experts' owners under expert parallelism.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn

from switch_nerf_torch.models.common import uniform_fan_in
from switch_nerf_torch.ops.expert_kernel import expert_mlp_chain
from switch_nerf_torch.ops.fused_dispatch import fused_dispatch_chain
from switch_nerf_torch.ops.ragged_chain import ragged_chain
from switch_nerf_torch.parallel import experts as ep_ops
from switch_nerf_torch.parallel import weights as wp_ops
from switch_nerf_torch.parallel.mesh import DATA, EXPERT, Mesh

__all__ = ["ExpertMLP", "FFNExperts", "localize", "hold_whole", "gathered",
           "hold_for_pass"]


class ExpertMLP(nn.Module):
    def __init__(self, model_dim: int, num_experts: int, layer_num: int,
                 skips: Optional[Sequence[int]] = None,
                 init_factor: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        m = model_dim
        self.layer_num = layer_num
        self.num_experts = num_experts
        self.skips: Tuple[int, ...] = tuple(skips or ())
        for i in range(layer_num):
            self.register_parameter(f"w{i}", uniform_fan_in(
                (num_experts, m, m), m, generator, init_factor))
            self.register_parameter(f"b{i}", uniform_fan_in(
                (num_experts, 1, m), m, generator, init_factor))
        self.ep: Optional[Mesh] = None                 # set by localize
        self.wp: Optional[Mesh] = None                 # set by localize
        self.whole: Optional[List[torch.Tensor]] = None  # set by gathered
        self.held: Optional[List[torch.Tensor]] = None   # hold_for_pass

    def _own(self) -> List[torch.Tensor]:
        """This module's parameters: w0..w{L-1}, then b0..b{L-1}."""
        return ([getattr(self, f"w{i}") for i in range(self.layer_num)]
                + [getattr(self, f"b{i}") for i in range(self.layer_num)])

    def _weights(self) -> List[torch.Tensor]:
        """This rank's experts with their whole last dimension: under
        weight parallelism the pass's gathered copy (``hold_for_pass``),
        else the parameters."""
        if self.held is not None:
            return self.held
        if self.wp is not None:
            raise RuntimeError(
                "expert weight parallelism: the experts' column blocks are "
                "gathered once a training pass; run the pass inside "
                "models.experts.hold_for_pass (or the eval inside gathered)")
        return self._own()

    def _stack(self, tensors: Sequence[torch.Tensor], dtype: torch.dtype):
        n = self.layer_num
        return (torch.stack([t.to(dtype) for t in tensors[:n]]),
                torch.stack([t.to(dtype) for t in tensors[n:]]))

    def whole_weights(self) -> Sequence[torch.Tensor]:
        """The whole model's tensors in ``_own``'s order (under expert
        parallelism gathered from the owners)."""
        if self.whole is not None:
            return self.whole
        if self.ep is not None:
            return ep_ops.WholeExperts.apply(self.ep, *self._weights())
        return self._weights()

    def stacked(self, dtype: torch.dtype):
        """The whole model's ([L, E, M, M], [L, E, 1, M]) in the compute
        dtype (under expert parallelism gathered from the owners)."""
        return self._stack(self.whole_weights(), dtype)

    def _local_chain(self, z: torch.Tensor) -> torch.Tensor:
        ws, bs = self._stack(self._weights(), z.dtype)
        return expert_mlp_chain(z, ws, bs, self.skips)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Padded form: x [E, C, M] -> [E, C, M]."""
        if self.ep is not None and self.whole is None:
            return ep_ops.chain(x, self._local_chain, self.ep)
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


class FFNExperts(ExpertMLP):
    """The 2-layer experts of --moe_expert_type ffn (JAX
    ``FusedFFNExperts``, ``switch_nerf_tpu/models/experts.py:106-147``):
    relu(x w1 + b1) w2 + b2 per expert, with the hidden width H of the
    layer's h_ch (or M). Init as JAX's: every leaf U(+-1/sqrt(fan_in)),
    fan-in M for w1 and b1, H for w2 and b2, no init_factor.

    When H == M the function is the ExpertMLP chain of L = 2 with no
    skip (ReLU after the first layer, none after the last), so it runs on
    the chain's kernels: K1 / K2 padded, K1R / K2R ragged, with w1 / w2
    and b1 / b2 stacked as the chain's layers. Otherwise it is two
    batched products (``torch.bmm``, padded) or per-expert products over
    the count slices (ragged), as JAX computes it with einsum and
    ragged_dot outside any Pallas kernel. It is an ExpertMLP to the
    parallel code: its leaves are cut, gathered and exchanged alike."""

    def __init__(self, model_dim: int, num_experts: int, hidden_size: int,
                 generator: Optional[torch.Generator] = None):
        nn.Module.__init__(self)
        m, h, e = model_dim, hidden_size, num_experts
        self.layer_num, self.num_experts, self.skips = 2, e, ()
        self.w1 = uniform_fan_in((e, m, h), m, generator)
        self.b1 = uniform_fan_in((e, 1, h), m, generator)
        self.w2 = uniform_fan_in((e, h, m), h, generator)
        self.b2 = uniform_fan_in((e, 1, m), h, generator)
        self.ep = self.wp = None
        self.whole = self.held = None

    def _own(self) -> List[torch.Tensor]:
        return [self.w1, self.w2, self.b1, self.b2]

    def _square(self, tensors: Sequence[torch.Tensor]) -> bool:
        return tensors[0].shape[-1] == tensors[0].shape[-2]

    def _chain(self, x: torch.Tensor, tensors: Sequence[torch.Tensor]
               ) -> torch.Tensor:
        """Padded form on [E, C, M] with the experts' tensors."""
        if self._square(tensors):
            ws, bs = self._stack(tensors, x.dtype)
            return expert_mlp_chain(x, ws, bs, ())
        w1, w2, b1, b2 = (t.to(x.dtype) for t in tensors)
        h = torch.relu(torch.bmm(x, w1) + b1)
        return torch.bmm(h, w2) + b2

    def _local_chain(self, z: torch.Tensor) -> torch.Tensor:
        return self._chain(z, self._weights())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ep is not None and self.whole is None:
            return ep_ops.chain(x, self._local_chain, self.ep)
        return self._chain(x, self.whole_weights())

    def ragged(self, x: torch.Tensor, counts: torch.Tensor,
               row_expert: torch.Tensor) -> torch.Tensor:
        del row_expert
        tensors = self.whole_weights()
        if self._square(tensors):
            ws, bs = self._stack(tensors, x.dtype)
            return ragged_chain(x, counts, ws, bs, ())
        w1, w2, b1, b2 = (t.to(x.dtype) for t in tensors)
        outs, lo = [], 0
        for e, n in enumerate(counts.tolist()):      # host sync: H != M
            h = torch.relu(x[lo:lo + n] @ w1[e] + b1[e])
            outs.append(h @ w2[e] + b2[e])
            lo += n
        return torch.cat(outs)


def _expert_modules(model: Optional[nn.Module]) -> List[ExpertMLP]:
    """The MoE layers' experts of `model`: the ExpertMLP modules named
    ``experts``, the leaves JAX's layout rule cuts (a residual MoE's
    one-expert ``residual_expert`` stays whole, as JAX's
    ``_EXPERT_PATH_RE`` does not match it)."""
    if model is None:
        return []
    return [m for name, m in model.named_modules()
            if isinstance(m, ExpertMLP) and name.split(".")[-1] == "experts"]


def localize(model: nn.Module, mesh: Mesh) -> None:
    """Keep each MoE layer's experts' part on this rank of `mesh`, in
    place, as ``mesh.spec`` lays out its leaves: the block of experts over
    the expert axis (tagged ``p.expert_mesh``) and, under weight
    parallelism, the column block of the last dimension over the data
    axis (tagged ``p.weight_mesh``); the parameters become copies of their
    parts."""
    for mod in _expert_modules(model):
        # all of a module's leaves must be cut alike (every ExpertMLP
        # leaf ends in M; an ffn's in H or M)
        cuts = set()
        for name, p in list(mod.named_parameters(recurse=False)):
            spec = mesh.spec(("experts", name), p.shape, mod.num_experts)
            experts = EXPERT in spec and mesh.splits_experts
            columns = bool(spec) and spec[-1] == DATA and mesh.data > 1
            cuts.add((experts, columns))
            if experts or columns:
                local = nn.Parameter(mesh.cut(p.detach(), spec).clone())
                if experts:
                    local.expert_mesh = mesh
                if columns:
                    local.weight_mesh = mesh
                setattr(mod, name, local)
        if len(cuts) > 1:
            raise ValueError(
                f"expert weight parallelism: the data axis ({mesh.data}) "
                "must divide every expert leaf's last dimension or none "
                "(an ffn's H and M)")
        mod.ep = mesh if experts else None
        mod.wp = mesh if columns else None


def _whole_no_grad(m: ExpertMLP) -> List[torch.Tensor]:
    """The whole experts of `m`: its column blocks gathered over the data
    group, then its experts over the expert group."""
    ts = m._own()
    if m.wp is not None:
        ts = wp_ops.gather(ts, m.wp)
    if m.ep is not None:
        ts = ep_ops.gather_whole(ts, m.ep)
    return ts


def hold_whole(*models: Optional[nn.Module]) -> List[ExpertMLP]:
    """Gather every expert- or weight-parallel ExpertMLP of `models` from
    its holders (collectives of its groups) and run it whole from now on;
    returns the modules it gathered (those not whole already)."""
    mods = [m for model in models for m in _expert_modules(model)
            if (m.ep is not None or m.wp is not None) and m.whole is None]
    with torch.no_grad():
        for m in mods:
            m.whole = _whole_no_grad(m)
    return mods


@contextlib.contextmanager
def gathered(*models: Optional[nn.Module]) -> Iterator[None]:
    """Run the block with the whole models (``hold_whole``), dropping the
    gathered experts on exit."""
    mods = hold_whole(*models)
    try:
        yield
    finally:
        for m in mods:
            m.whole = None


@contextlib.contextmanager
def hold_for_pass(*models: Optional[nn.Module]) -> Iterator[None]:
    """Run one training pass with every weight-parallel ExpertMLP's column
    blocks gathered once, differentiably (``parallel/weights.
    GatherWeights``: one gather of all of them now, one reduce-scatter of
    their gradients in the backward); the copy is dropped on exit. A
    no-op without weight parallelism."""
    mods = [m for model in models for m in _expert_modules(model)
            if m.wp is not None]
    if not mods:
        yield
        return
    whole = iter(wp_ops.GatherWeights.apply(
        mods[0].wp, *[p for m in mods for p in m._own()]))
    for m in mods:
        m.held = [next(whole) for _ in range(2 * m.layer_num)]
    try:
        yield
    finally:
        for m in mods:
            m.held = None
