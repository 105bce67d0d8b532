"""The port's ('data', 'expert') mesh: its sizes and process groups.

JAX builds one mesh of every device, ``np.asarray(devices).reshape(d, e)``
with axes ('data', 'expert') (``switch_nerf_tpu/parallel/mesh.py:41-60``).
The port runs one process per card, so rank r sits at d = r // E,
e = r % E of a (D, E) mesh:

  * ``--mesh_shape D`` or ``D 1`` (the default: every process on the data
    axis), or any shape without ``--expert_parallel``, is pure data
    parallelism: every rank holds the whole model and the gradients are
    averaged over the ranks;
  * ``--expert_parallel`` with ``--mesh_shape D E`` (D * E the number of
    processes, E dividing ``--moe_expert_num``) spreads the experts over
    the expert axis: rank r holds experts [e E_loc, (e + 1) E_loc) with
    E_loc = experts / E, and their Adam moments. Its **expert group** is
    the E ranks with its d (the token exchange, ``experts.py``), its
    **data group** the D ranks with its e (the expert gradients' sum).

Every rank creates every group, in one order (``dist.new_group`` asks it),
when the mesh is set up (``setup``). Under NCCL each expert group also has
a gloo twin for the exchange's host-side header. ``--expert_weight_parallel``
and ZeRO-1 (``--shard_optimizer_states``) wait for the next slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch.distributed as dist

__all__ = ["Mesh", "mesh_shape", "setup", "current"]


def _waits(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} waits for the next slice of the port's parallelism "
        "(ROADMAP Queue A item 8); the port runs data and expert "
        "parallelism")


def mesh_shape(hparams, world: int) -> Tuple[int, int]:
    """The (data, expert) mesh shape the flags ask for, checked against
    the process count; raises on the parallelism the port does not run."""
    if getattr(hparams, "expert_weight_parallel", False):
        raise _waits("--expert_weight_parallel")
    if getattr(hparams, "shard_optimizer_states", False):
        raise _waits("--shard_optimizer_states (ZeRO-1)")
    shape = getattr(hparams, "mesh_shape", None)
    if shape is None:
        return world, 1
    shape = tuple(int(x) for x in shape)
    if len(shape) not in (1, 2):
        raise ValueError(f"--mesh_shape {list(shape)}: give D or D E")
    d, e = shape[0], (shape[1] if len(shape) == 2 else 1)
    if d * e != world:
        raise ValueError(f"--mesh_shape {list(shape)}: D x E must be the "
                         f"number of processes, {world}")
    if e > 1 and not getattr(hparams, "no_expert_parallel", True):
        experts = hparams.moe_expert_num
        if experts % e:
            raise ValueError(f"--mesh_shape {d} {e}: the expert axis must "
                             f"divide --moe_expert_num {experts}")
    return d, e


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on an expert-parallel (D, E) mesh and its
    groups (None: the world group)."""
    data: int
    expert: int
    rank: int
    expert_group: Any
    data_group: Any
    host_group: Any

    @property
    def d_index(self) -> int:
        return self.rank // self.expert

    @property
    def e_index(self) -> int:
        return self.rank % self.expert

    def expert_ranks(self) -> List[int]:
        """The ranks of this rank's expert group, by e."""
        d = self.d_index
        return [d * self.expert + j for j in range(self.expert)]

    def data_ranks(self) -> List[int]:
        """The ranks of this rank's data group, by d."""
        return [j * self.expert + self.e_index for j in range(self.data)]

    def block(self, num_experts: int) -> Tuple[int, int]:
        """The experts [lo, hi) this rank holds."""
        local = num_experts // self.expert
        return self.e_index * local, (self.e_index + 1) * local


_CURRENT: Optional[Mesh] = None
# groups by (D, E), with the world group they were made in
_MADE: Dict[Tuple[int, int], Tuple[Any, Dict]] = {}


def _groups(d: int, e: int) -> Dict:
    """Every rank's expert and data groups (and the expert groups' gloo
    twins under NCCL), made on every rank in one order."""
    made = _MADE.get((d, e))
    if made is not None and made[0] is dist.group.WORLD:
        return made[1]
    world = d * e
    nccl = dist.get_backend() == "nccl"
    out: Dict = {"expert": {}, "data": {}, "host": {}}
    for i in range(d):
        ranks = [i * e + j for j in range(e)]
        out["expert"][i] = None if e == world else dist.new_group(ranks)
        out["host"][i] = (dist.new_group(ranks, backend="gloo") if nccl
                          else out["expert"][i])
    for j in range(e):
        ranks = [i * e + j for i in range(d)]
        out["data"][j] = None if d == world else dist.new_group(ranks)
    _MADE[(d, e)] = (dist.group.WORLD, out)
    return out


def setup(hparams, world: int, rank: int) -> Optional[Mesh]:
    """Check the flags (``mesh_shape``) and make the expert-parallel mesh
    the current one (None, the current one, under data parallelism: the
    flags have no expert axis longer than 1). Every rank calls it, in a
    process group when E > 1."""
    global _CURRENT
    d, e = mesh_shape(hparams, world)
    if e == 1 or getattr(hparams, "no_expert_parallel", True):
        _CURRENT = None
        return None
    if not dist.is_initialized():
        raise RuntimeError(f"--mesh_shape {d} {e}: expert parallelism runs "
                           "in a process group (torchrun)")
    g = _groups(d, e)
    _CURRENT = Mesh(d, e, rank, g["expert"][rank // e],
                    g["data"][rank % e], g["host"][rank // e])
    return _CURRENT


def current() -> Optional[Mesh]:
    """The expert-parallel mesh of this process's current process group
    (None: data parallelism)."""
    if _CURRENT is None or not dist.is_initialized():
        return None
    made = _MADE.get((_CURRENT.data, _CURRENT.expert))
    return _CURRENT if made and made[0] is dist.group.WORLD else None
