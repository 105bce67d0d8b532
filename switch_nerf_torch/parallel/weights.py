"""Expert weight parallelism: the gather of the experts' column blocks.

Port of ``--expert_weight_parallel`` (``switch_nerf_tpu/config.py:129-134``,
``switch_nerf_tpu/parallel/mesh.py:72-100``): every expert leaf
``[E_loc, ..., M_out]`` is cut on its last dimension over the data axis
(``mesh.leaf_spec``), so rank (d, e) holds ``[E_loc, ..., M_out / D]``,
column block d, and the Adam moments of that block. JAX lets GSPMD place
the weight all-gather; the port gathers once a training pass
(``models/experts.hold_for_pass``):

  * forward (``GatherWeights``): each member of the data group gives its
    shards, flat in one buffer; the gather makes every member's whole
    ``[E_loc, ..., M_out]``. The pass's MoE calls all run on that copy
    (K1/K2, K3/K4, K1R/K2R get whole weights, as without the flag);
  * backward: the whole weights' gradient, summed over the pass's calls by
    autograd, is summed over the data group and each member keeps its
    block (a reduce-scatter). The trainer then divides it by the world
    size as every other gradient (``trainer.TrainStep``).

One gather and one reduce-scatter a step, whatever the number of MoE
calls, so the members' call counts may differ. The collectives' form
follows the backend and the tensors' device, as ``experts.py``'s do:

  * NCCL: ``all_gather_into_tensor`` / ``reduce_scatter_tensor``;
  * gloo on CUDA tensors (several ranks on one card): the gather is an
    ``all_reduce`` of a zero buffer in which each member fills its own
    block, summed as integers of the same bits (exact); the
    reduce-scatter an ``all_reduce`` of which each member keeps its block;
  * gloo on CPU tensors: ``all_gather``, and the reduce-scatter as above.

``all_gather_flat`` is also ZeRO-1's gather of the updated slices
(``zero.ZeroAdam``) and expert parallelism's whole-expert gather
(``experts.gather_whole``).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from switch_nerf_torch.parallel.mesh import Mesh

__all__ = ["GatherWeights", "gather", "all_gather_flat", "join", "blocks",
           "STATS"]

# the training passes' gathers and reduce-scatters, the bytes of the whole
# tensors they made or split (every member's blocks together) and the
# form of the last collective
STATS = {"gathers": 0, "gather_bytes": 0, "reduce_scatters": 0,
         "reduce_scatter_bytes": 0, "form": None}


def form(t: torch.Tensor) -> str:
    """How a collective on `t` runs: ``nccl``, ``gloo_cuda`` or
    ``gloo_cpu``."""
    if dist.get_backend() == "nccl":
        return "nccl"
    return "gloo_cpu" if t.device.type == "cpu" else "gloo_cuda"


def _padded(n: int, itemsize: int) -> int:
    """n elements rounded up to whole 4-byte words."""
    return n + (-(n * itemsize) % 4) // itemsize


def all_gather_flat(flat: torch.Tensor, group, n: int, me: int
                    ) -> torch.Tensor:
    """Every member's flat tensor (the same size and dtype on each), as
    rows of an [n, numel] tensor; `me` is this member's row. Exact."""
    how = form(flat)
    STATS["form"] = how
    flat = flat.contiguous()
    if n == 1:
        return flat.reshape(1, -1)
    if how == "nccl":
        out = flat.new_empty(n * flat.numel())
        dist.all_gather_into_tensor(out, flat, group=group)
        return out.view(n, -1)
    if how == "gloo_cpu":
        out = flat.new_empty(n, flat.numel())
        dist.all_gather(list(out.unbind(0)), flat, group=group)
        return out
    per = flat.numel()
    buf = flat.new_zeros(_padded(n * per, flat.element_size()))
    buf[me * per:(me + 1) * per] = flat
    dist.all_reduce(buf.view(torch.int32), group=group)
    return buf[:n * per].view(n, per)


def _reduce_scatter_flat(rows: torch.Tensor, group, n: int, me: int
                         ) -> torch.Tensor:
    """rows [n, k]: the sum over the members of row `me`."""
    if n == 1:
        return rows[0]
    rows = rows.contiguous()
    if form(rows) == "nccl":
        out = rows.new_empty(rows.shape[1])
        dist.reduce_scatter_tensor(out, rows, group=group)
        return out
    dist.all_reduce(rows, group=group)
    return rows[me]


def join(rows: torch.Tensor, shapes: Sequence[torch.Size],
         dims: Sequence[int]) -> List[torch.Tensor]:
    """[n, sum k] rows (each member's blocks of the tensors, flat, one
    after another) -> the whole tensors, member j's block of tensor i as
    the j-th block of its dimension dims[i]."""
    out, lo = [], 0
    for shape, dim in zip(shapes, dims):
        k = shape.numel()
        out.append(torch.cat(list(rows[:, lo:lo + k].reshape(-1, *shape)),
                             dim=dim))
        lo += k
    return out


def blocks(t: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``join``'s inverse for one tensor: its n blocks of dimension
    `dim`, each flat, as the rows of an [n, numel / n] tensor."""
    return torch.stack(t.chunk(n, dim)).reshape(n, -1)


def gather(shards: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The whole tensors of the data group's column blocks (no autograd):
    one gather of every shard at once."""
    flat = torch.cat([s.detach().reshape(-1) for s in shards])
    rows = all_gather_flat(flat, mesh.data_group, mesh.data, mesh.d_index)
    return join(rows, [s.shape for s in shards], [-1] * len(shards))


class GatherWeights(torch.autograd.Function):
    """``gather`` differentiably: the backward sums the whole gradients
    over the data group and gives each member its column block."""

    @staticmethod
    def forward(ctx, mesh, *shards):
        ctx.mesh, ctx.shapes = mesh, [s.shape for s in shards]
        whole = gather(shards, mesh)
        STATS["gathers"] += 1
        STATS["gather_bytes"] += sum(w.numel() * w.element_size()
                                     for w in whole)
        return tuple(whole)

    @staticmethod
    def backward(ctx, *grads):
        mesh, n = ctx.mesh, ctx.mesh.data
        rows = torch.cat([blocks(g, n, -1) for g in grads], dim=1)
        STATS["reduce_scatters"] += 1
        STATS["reduce_scatter_bytes"] += rows.numel() * rows.element_size()
        mine = _reduce_scatter_flat(rows, mesh.data_group, n, mesh.d_index)
        out, lo = [], 0
        for shape in ctx.shapes:
            out.append(mine[lo:lo + shape.numel()].view(shape))
            lo += shape.numel()
        return (None, *out)
