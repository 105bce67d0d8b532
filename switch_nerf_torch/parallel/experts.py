"""Expert parallelism: the token exchange around the expert chain.

Port of the all-to-all of ``switch_nerf_tpu/models/moe.py:201-216`` (GSPMD
places it where ``moe.py:195-200`` shards the dispatch buffer over the
'expert' axis). On a (D, E) mesh (``mesh.py``) rank e of an expert group
holds experts [e E_loc, (e + 1) E_loc). Each MoE call of a padded
training pass:

  * the rank's ``[E, C_r, M]`` dispatch buffer goes out by expert block:
    block j to member j of its expert group. The owner gets
    ``[E_loc, sum_r C_r, M]``, the members' rows in member order, as JAX's
    ``[ep, E_loc, C, M]`` -> transpose -> ``[E_loc, ep C, M]``;
  * the owner runs its local experts (K1 forward, K2 backward) on them;
  * the reverse exchange returns each member's rows (``chain``).

The backward of each exchange is the other one, so an owner's expert
gradients sum the tokens of its whole expert group. ``C_r`` may differ
between members (a last, shorter chunk): every call starts with a small
header over the group's host (gloo) group that carries each member's C_r
and its call number, so a member that makes another number of calls than
its group raises on every member instead of hanging (``end_pass`` closes
a pass).

Under --remat (``remat.py``) the backward recomputes each chunk, and
with it the exchanges of its MoE calls and its whole-expert gathers
(every rank recomputes the same chunks in the same order, so they pair
up); the recompute takes each call's header as the forward made it, so
``_SEQ`` and ``end_pass``'s check see the forward's calls only.

The form of an exchange follows the backend and the tensor's device:
``all_to_all_single`` under NCCL and for CPU tensors under gloo;
``all_reduce`` of a zero buffer in which each member fills its own blocks
(bit views summed as integers, so the sum is exact, signs of zeros too)
for CUDA tensors under gloo, which has no all-to-all on them (several
ranks on one card). ``gather_whole`` gives the whole ``[E, ...]`` of
expert tensors (``weights.all_gather_flat``, whose forms follow the same
rule): eval and no-drop dispatch run the whole model
(``models/experts.py``), and rank 0 writes whole checkpoints.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from switch_nerf_torch import remat
from switch_nerf_torch.parallel.mesh import Mesh
from switch_nerf_torch.parallel.weights import _padded, all_gather_flat, join

__all__ = ["mesh_of", "form", "chain", "gather_whole", "WholeExperts",
           "begin_pass", "end_pass", "STATS"]

_CALL, _GATHER, _END = 1, 2, 3
_NAMES = {_CALL: "an expert exchange", _GATHER: "a whole-expert gather",
          _END: "the end of its pass"}
_SEQ = {"n": 0}
# exchanges made, the bytes this rank sent in them and the form they took
STATS = {"exchanges": 0, "bytes": 0, "form": None}


def mesh_of(params: Iterable[torch.Tensor]) -> Optional[Mesh]:
    """The mesh whose block of experts any of `params` is (parameters a
    rank holds under expert parallelism carry it as ``expert_mesh``);
    None under data parallelism."""
    return next((m for m in (getattr(p, "expert_mesh", None)
                             for p in params) if m is not None), None)


def form(t: torch.Tensor) -> str:
    """How a tensor's exchange runs: ``all_to_all`` (NCCL; gloo on CPU
    tensors) or ``all_reduce`` (gloo on CUDA tensors)."""
    if dist.get_backend() == "nccl" or t.device.type == "cpu":
        return "all_to_all"
    return "all_reduce"


def _header(mesh: Mesh, kind: int, value: int) -> List[int]:
    """Every member's value, after checking that every member of the
    expert group is at the same call of its pass."""
    seq = _SEQ["n"]
    _SEQ["n"] = 0 if kind == _END else seq + 1
    row = torch.zeros(mesh.expert, 3, dtype=torch.int64)
    row[mesh.e_index] = torch.tensor([kind, seq, value])
    dist.all_reduce(row, group=mesh.host_group)
    rows = row.tolist()
    for j, (k, s, _) in enumerate(rows):
        if (k, s) != (kind, seq):
            raise RuntimeError(
                f"expert parallelism out of lockstep: rank "
                f"{mesh.expert_ranks()[j]} is at {_NAMES.get(k, k)} "
                f"(call {s} of its pass), rank {mesh.rank} at "
                f"{_NAMES[kind]} (call {seq}); every rank of an expert "
                "group must make the same MoE calls in a pass")
    return [v for _, _, v in rows]


def begin_pass() -> None:
    """Number this process's next exchange 0 (a pass starts)."""
    _SEQ["n"] = 0


def end_pass(mesh: Mesh) -> None:
    """Close a pass: raises on every member if any made another number
    of exchanges."""
    _header(mesh, _END, 0)


def _exchange(blocks: List[torch.Tensor], sizes: List[List[int]],
              mesh: Mesh, how: Optional[str] = None) -> List[torch.Tensor]:
    """blocks[j] (flat) goes to member j; sizes[i][j] is what member i
    sends member j. Returns what each member sent this one, flat. `how`
    names the form (None: ``form``'s; a check runs the other one)."""
    me, n = mesh.e_index, mesh.expert
    like = blocks[0]
    got = [sizes[i][me] for i in range(n)]
    STATS["exchanges"] += 1
    STATS["bytes"] += sum(sizes[me]) * like.element_size()
    STATS["form"] = how or form(like)
    if STATS["form"] == "all_to_all":
        recv = like.new_empty(sum(got))
        dist.all_to_all_single(recv, torch.cat(blocks), got, sizes[me],
                               group=mesh.expert_group)
        return list(recv.split(got))
    offsets, lo = [], 0
    for i in range(n):
        offsets.append([])
        for j in range(n):
            offsets[i].append(lo)
            lo += sizes[i][j]
    buf = like.new_zeros(_padded(lo, like.element_size()))
    for j in range(n):
        buf[offsets[me][j]:offsets[me][j] + sizes[me][j]] = blocks[j]
    dist.all_reduce(buf.view(torch.int32), group=mesh.expert_group)
    return [buf[offsets[i][me]:offsets[i][me] + got[i]] for i in range(n)]


def _to_owners(x: torch.Tensor, mesh: Mesh, caps: List[int],
               how: Optional[str] = None) -> torch.Tensor:
    """[E, C_me, M] -> [E_loc, sum C, M] on the owner."""
    n = mesh.expert
    e_loc, m = x.shape[0] // n, x.shape[2]
    x = x.contiguous()
    blocks = [x[j * e_loc:(j + 1) * e_loc].reshape(-1) for j in range(n)]
    sizes = [[e_loc * caps[i] * m] * n for i in range(n)]
    recv = _exchange(blocks, sizes, mesh, how)
    return torch.cat([r.view(e_loc, caps[i], m) for i, r in enumerate(recv)],
                     dim=1)


def _from_owners(y: torch.Tensor, mesh: Mesh, caps: List[int]
                 ) -> torch.Tensor:
    """[E_loc, sum C, M] -> each member's [E, C, M]."""
    n, me = mesh.expert, mesh.e_index
    e_loc, m = y.shape[0], y.shape[2]
    blocks = [p.contiguous().reshape(-1) for p in y.split(caps, dim=1)]
    sizes = [[e_loc * caps[j] * m for j in range(n)] for _ in range(n)]
    recv = _exchange(blocks, sizes, mesh)
    return torch.cat([r.view(e_loc, caps[me], m) for r in recv], dim=0)


class _ToOwners(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, caps):
        ctx.mesh, ctx.caps = mesh, caps
        return _to_owners(x, mesh, caps)

    @staticmethod
    def backward(ctx, g):
        return _from_owners(g, ctx.mesh, ctx.caps), None, None


class _FromOwners(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh, caps):
        ctx.mesh, ctx.caps = mesh, caps
        return _from_owners(y, mesh, caps)

    @staticmethod
    def backward(ctx, g):
        return _to_owners(g, ctx.mesh, ctx.caps), None, None


def chain(x: torch.Tensor, local_chain: Callable[[torch.Tensor],
                                                 torch.Tensor],
          mesh: Mesh) -> torch.Tensor:
    """[E, C, M] dispatch buffer -> [E, C, M] expert outputs, the experts
    run by their owners: exchange, ``local_chain`` on [E_loc, sum C, M],
    reverse exchange."""
    # a remat recompute (remat.py) takes the forward's header: the pass
    # was closed by end_pass, and the check has been made
    caps = remat.keep(_header, mesh, _CALL, x.shape[1])
    z = _ToOwners.apply(x, mesh, caps)
    return _FromOwners.apply(local_chain(z), mesh, caps)


def gather_whole(tensors: Sequence[torch.Tensor], mesh: Mesh
                 ) -> List[torch.Tensor]:
    """Each member's [E_loc, ...] tensors -> the whole [E, ...], exactly
    (``weights.all_gather_flat`` over the expert group). Every member
    calls it with tensors of the same shapes and dtype."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    rows = all_gather_flat(flat, mesh.expert_group, mesh.expert,
                           mesh.e_index)
    return join(rows, [t.shape for t in tensors], [0] * len(tensors))


class WholeExperts(torch.autograd.Function):
    """The whole experts' tensors from the local ones, differentiably: the
    backward sums the whole gradients over the expert group and keeps this
    rank's block (a no-drop training pass)."""

    @staticmethod
    def forward(ctx, mesh, *local):
        remat.keep(_header, mesh, _GATHER, 0)
        ctx.mesh, ctx.rows = mesh, [t.shape[0] for t in local]
        return tuple(gather_whole(local, mesh))

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.mesh
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        dist.all_reduce(flat, group=mesh.expert_group)
        out, lo = [], 0
        for g, rows in zip(grads, ctx.rows):
            k = g.numel()
            whole = flat[lo:lo + k].view(g.shape).to(g.dtype)
            out.append(whole[mesh.e_index * rows:(mesh.e_index + 1) * rows])
            lo += k
        return (None, *out)
