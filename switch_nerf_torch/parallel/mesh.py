"""The port's ('data', 'expert') mesh: its sizes, its groups and the
layout of every leaf on it.

JAX builds one mesh of every device, ``np.asarray(devices).reshape(d, e)``
with axes ('data', 'expert') (``switch_nerf_tpu/parallel/mesh.py:41-60``).
The port runs one process per card, so rank r sits at d = r // E,
e = r % E of a (D, E) mesh, and holds what JAX's device (d, e) holds:

  * ``--mesh_shape D`` or ``D 1`` (the default: every process on the data
    axis), or any shape without the flags below, is pure data
    parallelism: every rank holds the whole model and the gradients are
    averaged over the ranks (no ``Mesh``);
  * ``--expert_parallel`` with ``--mesh_shape D E`` (D * E the number of
    processes, E dividing ``--moe_expert_num``) spreads the experts over
    the expert axis: rank r holds experts [e E_loc, (e + 1) E_loc) with
    E_loc = experts / E, and their Adam moments. Its **expert group** is
    the E ranks with its d (the token exchange, ``experts.py``), its
    **data group** the D ranks with its e;
  * ``--expert_weight_parallel`` also cuts every expert leaf's last (output)
    dimension over the data axis, where D divides it: rank r holds the
    d-th of D column blocks (``weights.py`` gathers them once a training
    pass). A leaf whose last dimension D does not divide stays whole;
  * ``--shard_optimizer_states`` (ZeRO-1) keeps Adam's moments of every
    leaf that is otherwise whole, at least 2-D and whose first dimension
    D divides, for the d-th block of that dimension only
    (``zero.ZeroAdam``).

``leaf_spec`` is JAX's rule (``expert_leaf_spec`` and
``opt_state_shardings``, ``switch_nerf_tpu/parallel/mesh.py:72-174``) in
JAX's leaf layout: flax's [in, out] kernels, so a torch ``Linear.weight``'s
dimension 0 in JAX is its dimension 1 (``bridge.py`` maps the two).

Every rank creates every group, in one order (``dist.new_group`` asks it),
when the mesh is set up (``setup``). Under NCCL each expert group also has
a gloo twin for the exchange's host-side header.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist

__all__ = ["Mesh", "mesh_shape", "setup", "current", "leaf_spec", "DATA",
           "EXPERT"]

DATA, EXPERT = "data", "expert"
Spec = Tuple[Optional[str], ...]


def mesh_shape(hparams, world: int) -> Tuple[int, int]:
    """The (data, expert) mesh shape the flags ask for, checked against
    the process count."""
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


def leaf_spec(path: Sequence[str], shape: Sequence[int], num_experts: int,
              *, expert_parallel: bool, weight_parallel: bool, data: int,
              zero: bool = False, moment: bool = False) -> Spec:
    """JAX's PartitionSpec of a leaf, as a tuple of axis names (None: not
    cut), in JAX's layout. An expert leaf (a path through ``experts``,
    the experts leading) is cut on dim 0 over 'expert' under expert
    parallelism and, under weight parallelism, on its last dim over
    'data' where D divides it (at least 2-D). A leaf of Adam's state
    (``moment``) that is still whole under ZeRO-1 (``zero``), at least
    2-D, with D dividing its dim 0, is cut there over 'data'."""
    ndim = len(shape)
    spec: Spec = ()
    if "experts" in path and ndim >= 1 and shape[0] == num_experts:
        first = EXPERT if expert_parallel else None
        if weight_parallel and ndim >= 2 and shape[-1] % data == 0:
            spec = (first,) + (None,) * (ndim - 2) + (DATA,)
        elif expert_parallel:
            spec = (EXPERT,)
    if (moment and zero and spec == () and ndim >= 2
            and shape[0] % data == 0):
        spec = (DATA,)
    return spec


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a (D, E) mesh, the layout flags and its groups
    (None: the world group)."""
    data: int
    expert: int
    rank: int
    expert_group: Any
    data_group: Any
    host_group: Any
    expert_parallel: bool = True
    weight_parallel: bool = False
    zero: bool = False

    @property
    def d_index(self) -> int:
        return self.rank // self.expert

    @property
    def e_index(self) -> int:
        return self.rank % self.expert

    @property
    def splits_experts(self) -> bool:
        """Whether the experts are spread over the ranks (an expert axis
        longer than 1 under --expert_parallel)."""
        return self.expert_parallel and self.expert > 1

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

    def spec(self, path: Sequence[str], shape: Sequence[int],
             num_experts: int, moment: bool = False) -> Spec:
        """``leaf_spec`` of a leaf (JAX layout) under this mesh's flags."""
        return leaf_spec(path, shape, num_experts,
                         expert_parallel=self.expert_parallel,
                         weight_parallel=self.weight_parallel,
                         data=self.data, zero=self.zero, moment=moment)

    def size(self, axis: str) -> int:
        return self.data if axis == DATA else self.expert

    def index(self, axis: str) -> int:
        return self.d_index if axis == DATA else self.e_index

    def cut(self, x, spec: Spec):
        """This rank's block of a whole array or tensor `x` laid out as
        `spec` says (numpy or torch; a view)."""
        index = []
        for n, axis in zip(x.shape, spec):
            if axis is None:
                index.append(slice(None))
            else:
                k = n // self.size(axis)
                index.append(slice(self.index(axis) * k,
                                   (self.index(axis) + 1) * k))
        return x[tuple(index)]


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
    """Check the flags (``mesh_shape``) and make their mesh the current
    one. None (the current one too) under pure data parallelism: one
    process, or none of --expert_weight_parallel, --shard_optimizer_states
    and an expert axis longer than 1 under --expert_parallel. Every rank
    calls it, in a process group when it makes a mesh."""
    global _CURRENT
    d, e = mesh_shape(hparams, world)
    ep = not getattr(hparams, "no_expert_parallel", True)
    wp = bool(getattr(hparams, "expert_weight_parallel", False))
    zero = bool(getattr(hparams, "shard_optimizer_states", False))
    if world == 1 or not ((ep and e > 1) or wp or zero):
        _CURRENT = None
        return None
    if not dist.is_initialized():
        raise RuntimeError(f"--mesh_shape {d} {e}: expert, weight and "
                           "optimizer-state parallelism run in a process "
                           "group (torchrun)")
    g = _groups(d, e)
    _CURRENT = Mesh(d, e, rank, g["expert"][rank // e],
                    g["data"][rank % e], g["host"][rank // e],
                    expert_parallel=ep, weight_parallel=wp, zero=zero)
    return _CURRENT


def current() -> Optional[Mesh]:
    """The mesh of this process's current process group (None: pure data
    parallelism)."""
    if _CURRENT is None or not dist.is_initialized():
        return None
    made = _MADE.get((_CURRENT.data, _CURRENT.expert))
    return _CURRENT if made and made[0] is dist.group.WORLD else None
