"""ZeRO-1: Adam's moments of a leaf kept for this rank's slice only.

Port of ``--shard_optimizer_states`` (``switch_nerf_tpu/config.py:124-128``,
``switch_nerf_tpu/parallel/mesh.py:136-174``, ``runner.py:486-497``). A
leaf whose moments ``mesh.leaf_spec`` cuts over 'data' (whole otherwise,
at least 2-D, its JAX dim 0 divisible by D) keeps Adam's moments for
block d of that dimension on rank (d, e). JAX lets GSPMD update each
shard and all-gather the parameter; ``ZeroAdam`` does the same by hand:

  * the parameter stays whole on every rank, and its gradient is the
    averaged one every data-parallel rank has;
  * each step, Adam updates the rank's slice (a contiguous copy, with the
    slice's own moments); the other leaves keep whole moments;
  * the updated slices are all-gathered over the data group
    (``weights.all_gather_flat``: one collective for every leaf) into the
    parameters, so the replicas stay bit-equal by construction.

Adam is elementwise: a slice's update is the whole tensor's, bit for bit,
with the per-tensor and the foreach kernels alike
(``tests/test_torch_weight_parallel.py`` on the CPU, ``chip_smoke.py``
phase 13 on the card). The slice's dimension is torch's: JAX's dim 0 of
a flax kernel [in, out] is dim 1 of the ``Linear.weight`` [out, in]
(``bridge.zero_dims``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from switch_nerf_torch.parallel.mesh import Mesh
from switch_nerf_torch.parallel.weights import all_gather_flat, join

__all__ = ["ZeroAdam", "key_of"]


class ZeroAdam(torch.optim.Adam):
    """``torch.optim.Adam`` over the parameters, the leaves with a
    dimension in `dims` (one entry a parameter, None: whole) through this
    rank's slice of that dimension over `mesh`'s data group."""

    def __init__(self, params: Sequence[torch.Tensor],
                 dims: Sequence[Optional[int]], mesh: Mesh, **kw):
        self.mesh = mesh
        self.dims: Dict[torch.Tensor, int] = {}
        self.slices: Dict[torch.Tensor, torch.Tensor] = {}
        keys: List[torch.Tensor] = []
        for p, dim in zip(params, dims):
            if dim is None:
                keys.append(p)
                continue
            self.dims[p] = dim
            self.slices[p] = self.mine(p.detach(), p).clone()
            keys.append(self.slices[p])
        super().__init__(keys, **kw)

    def key(self, p: torch.Tensor) -> torch.Tensor:
        """The tensor Adam keeps `p`'s state under."""
        return self.slices.get(p, p)

    def mine(self, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """This rank's slice of `t`, a whole tensor shaped like `p`."""
        dim = self.dims.get(p)
        if dim is None:
            return t
        k = t.shape[dim] // self.mesh.data
        return t.narrow(dim, self.mesh.d_index * k, k)

    def gather(self, slices: Sequence[torch.Tensor],
               params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The whole tensors of the data group's slices of `params` (one
        collective of every rank of the group, in the same order)."""
        mesh = self.mesh
        rows = all_gather_flat(torch.cat([s.reshape(-1) for s in slices]),
                               mesh.data_group, mesh.data, mesh.d_index)
        return join(rows, [s.shape for s in slices],
                    [self.dims[p] for p in params])

    def whole(self, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """A state tensor of `p`'s key made whole (a collective for a
        sliced leaf)."""
        return self.gather([t], [p])[0] if p in self.dims else t

    @torch.no_grad()
    def step(self, closure=None):
        for p, s in self.slices.items():
            s.copy_(self.mine(p, p))
            s.grad = (None if p.grad is None
                      else self.mine(p.grad, p).contiguous())
        loss = super().step(closure)
        if self.slices:
            params = list(self.slices)
            for p, w in zip(params, self.gather(
                    [self.slices[p] for p in params], params)):
                p.copy_(w)
        return loss

    def zero_grad(self, set_to_none: bool = True) -> None:
        super().zero_grad(set_to_none)
        for p in self.slices:
            p.grad = None


def key_of(optimizer: torch.optim.Optimizer, p: torch.Tensor
           ) -> torch.Tensor:
    """The tensor `optimizer` keeps `p`'s state under."""
    return optimizer.key(p) if isinstance(optimizer, ZeroAdam) else p
