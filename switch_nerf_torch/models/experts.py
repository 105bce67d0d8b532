"""Stacked expert MLPs: the FLOP core of the MoE layer.

Port of ``switch_nerf_tpu/models/experts.py:28-103`` (ExpertMLP, padded,
ragged and fused-dispatch forms). Parameters w{i} [E, M, M] and b{i}
[E, 1, M] keep the JAX layout. On the card every form runs hand-written
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
from switch_nerf_torch.parallel.mesh import Mesh

__all__ = ["ExpertMLP", "localize", "hold_whole", "gathered"]


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
        self.whole: Optional[List[torch.Tensor]] = None  # set by gathered

    def _own(self) -> List[torch.Tensor]:
        """This module's parameters: w0..w{L-1}, then b0..b{L-1}."""
        return ([getattr(self, f"w{i}") for i in range(self.layer_num)]
                + [getattr(self, f"b{i}") for i in range(self.layer_num)])

    def _stack(self, tensors: Sequence[torch.Tensor], dtype: torch.dtype):
        n = self.layer_num
        return (torch.stack([t.to(dtype) for t in tensors[:n]]),
                torch.stack([t.to(dtype) for t in tensors[n:]]))

    def stacked(self, dtype: torch.dtype):
        """The whole model's ([L, E, M, M], [L, E, 1, M]) in the compute
        dtype (under expert parallelism gathered from the owners)."""
        if self.whole is not None:
            return self._stack(self.whole, dtype)
        if self.ep is not None:
            return self._stack(ep_ops.WholeExperts.apply(self.ep,
                                                         *self._own()), dtype)
        return self._stack(self._own(), dtype)

    def _local_chain(self, z: torch.Tensor) -> torch.Tensor:
        ws, bs = self._stack(self._own(), z.dtype)
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


def localize(model: nn.Module, mesh: Mesh) -> None:
    """Keep each ExpertMLP's block of experts on this rank of `mesh`, in
    place: the parameters become their [lo, hi) slices (copies), tagged
    with the mesh (``p.expert_mesh``)."""
    for mod in model.modules():
        if not isinstance(mod, ExpertMLP):
            continue
        lo, hi = mesh.block(mod.num_experts)
        for name, p in list(mod.named_parameters(recurse=False)):
            local = nn.Parameter(p.detach()[lo:hi].clone())
            local.expert_mesh = mesh
            setattr(mod, name, local)
        mod.ep = mesh


def hold_whole(model: Optional[nn.Module]) -> List[ExpertMLP]:
    """Gather every expert-parallel ExpertMLP of `model` from its owners
    (a collective of the expert group) and run it whole from now on;
    returns the modules it gathered (those not whole already)."""
    mods = ([m for m in model.modules() if isinstance(m, ExpertMLP)
             and m.ep is not None and m.whole is None]
            if model is not None else [])
    with torch.no_grad():
        for m in mods:
            m.whole = ep_ops.gather_whole(m._own(), m.ep)
    return mods


@contextlib.contextmanager
def gathered(model: Optional[nn.Module]) -> Iterator[None]:
    """Run the block with the whole model (``hold_whole``), dropping the
    gathered experts on exit."""
    mods = hold_whole(model)
    try:
        yield
    finally:
        for m in mods:
            m.whole = None
