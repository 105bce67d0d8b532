"""Model chunks of a data-parallel training step on the global point grid.

JAX's train step runs one program over the global batch: the ranks' local
batches, in rank order (``switch_nerf_tpu/runner.py:517-542``), and
``run_model_chunked`` (``switch_nerf_tpu/render/rendering.py:98-186``)
cuts each pass's global point array into contiguous ``--model_chunk_size``
chunks, the last one the global remainder. A chunk's capacity, its
batch-prioritized order and its ``l_aux`` are taken over exactly its own
tokens. The port's ranks hold equal shares, so in a pass of P points a
rank, rank r's points start at the global offset r * P, and the port cuts
on the same grid (``plan``):

  * a chunk inside one rank runs there as in one process, with no
    collective (the published Building and Mission Bay runs: every pass of
    a rank is a whole number of chunks);
  * a chunk that spans ranks is routed over all of its tokens. Each rank
    runs its piece through the model; the MoE layers read the piece's
    ``ChunkShare`` (``current_share``) and exchange every token's top-1
    expert and gate value with the other holders (one ``all_reduce(SUM)``
    of a zero buffer of the chunk's length that each fills at its own
    offsets), so every holder takes the same routing decision and keeps
    its own tokens' slots (``ops/routing.extract_critical``).

Device collectives stay ``all_reduce``, which gloo also runs on CUDA
tensors. A chunk spanning a subset of the ranks reduces over a subgroup;
every rank creates the subgroups of a pass, in the same order, before it
runs the pass (``plan``), as ``dist.new_group`` asks.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from switch_nerf_torch.parallel import mesh

__all__ = ["RankGrid", "ChunkShare", "Piece", "plan", "check_lockstep",
           "current_share", "sharing"]


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """This rank's place among ranks holding equal, rank-ordered shares of
    the global batch."""
    rank: int
    world: int


@dataclasses.dataclass(frozen=True)
class ChunkShare:
    """This rank's part of a global chunk that spans ranks: the chunk's
    token count, where this rank's tokens start in it, and the first and
    last rank holding part of it."""
    total: int
    offset: int
    ranks: Tuple[int, int]

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """[..., n] of this rank's tokens -> [..., total] of the chunk's,
        in chunk order: a zero buffer filled at this rank's offsets and
        summed over the holders (each position has one nonzero term, so
        the sum is exact)."""
        n = local.shape[-1]
        buf = local.new_zeros(local.shape[:-1] + (self.total,))
        buf[..., self.offset:self.offset + n] = local
        dist.all_reduce(buf, group=_group(self.ranks))
        return buf


@dataclasses.dataclass(frozen=True)
class Piece:
    """Rows start .. stop of this rank's pass, all in global chunk
    `chunk`; `share` is None when the chunk lies inside this rank."""
    start: int
    stop: int
    chunk: int
    share: Optional[ChunkShare]


# subgroups by (first, last) rank, with the world group they were made in
_GROUPS: Dict[Tuple[int, int], Tuple[object, object]] = {}


def _group(ranks: Tuple[int, int]):
    first, last = ranks
    if first == 0 and last == dist.get_world_size() - 1:
        return None                               # the default group
    made = _GROUPS.get(ranks)
    if made is None or made[0] is not dist.group.WORLD:
        raise RuntimeError(f"no subgroup of ranks {first}..{last}: "
                           "plan() makes it before the pass runs")
    return made[1]


def _make_groups(spans: List[Tuple[int, int]], world: int) -> None:
    """Create, on every rank and in the same order, the subgroups of
    `spans` that the current world group lacks."""
    for first, last in sorted(set(spans)):
        if first == 0 and last == world - 1:
            continue
        made = _GROUPS.get((first, last))
        if made is None or made[0] is not dist.group.WORLD:
            _GROUPS[(first, last)] = (
                dist.group.WORLD, dist.new_group(list(range(first, last + 1))))


def plan(points: int, chunk_size: int, grid: RankGrid
         ) -> Tuple[List[Piece], int]:
    """This rank's pieces of a pass of `points` points per rank, on JAX's
    global chunk grid, and the number of global chunks. Chunks are
    min(chunk_size, global points) long; the last is the remainder. In a
    process group, the subgroups of the pass's shared chunks are made
    first: every rank calls it for every pass, in the same order. Under
    expert parallelism the pass must keep the ranks in lockstep
    (``check_lockstep``)."""
    out, spans, n_chunks = _pieces(points, chunk_size, grid)
    if spans and dist.is_initialized():
        _make_groups(spans, grid.world)
    if mesh.current() is not None:
        check_lockstep(points, chunk_size, grid.world)
    return out, n_chunks


def check_lockstep(points: int, chunk_size: int, world: int) -> None:
    """Under expert parallelism every MoE call of a pass exchanges tokens
    with the rank's expert group, so every rank must cut its pass into as
    many pieces, and a chunk that spans ranks (whose routing is a
    collective of its holders) must be the same piece of each holder's
    pass. The published runs keep both (every pass a whole number of
    chunks a rank). It is arithmetic, so every rank raises alike."""
    cuts = [_pieces(points, chunk_size, RankGrid(r, world))[0]
            for r in range(world)]
    counts = {len(c) for c in cuts}
    where: Dict[int, set] = {}
    for c in cuts:
        for i, piece in enumerate(c):
            if piece.share is not None:
                where.setdefault(piece.chunk, set()).add(i)
    if len(counts) > 1 or any(len(at) > 1 for at in where.values()):
        raise ValueError(
            f"expert parallelism: a pass of {points} points a rank cut into "
            f"{chunk_size}-point chunks gives the ranks "
            f"{[len(c) for c in cuts]} model calls, with chunks that span "
            "ranks at different calls; every rank must make the same "
            "exchanges (choose --model_chunk_size so that each rank's "
            "points are a whole number of chunks, or one chunk)")


def _pieces(points: int, chunk_size: int, grid: RankGrid
            ) -> Tuple[List[Piece], List[Tuple[int, int]], int]:
    """plan's arithmetic: this rank's pieces, the spans of the shared
    chunks and the number of global chunks."""
    total = points * grid.world
    chunk = min(chunk_size, total)
    n_chunks = -(-total // chunk)
    lo, hi = grid.rank * points, (grid.rank + 1) * points
    out, spans = [], []
    for k in range(n_chunks):
        c_lo, c_hi = k * chunk, min((k + 1) * chunk, total)
        span = (c_lo // points, (c_hi - 1) // points)
        if span[0] != span[1]:
            spans.append(span)
        start, stop = max(c_lo, lo), min(c_hi, hi)
        if start >= stop:
            continue
        share = (ChunkShare(c_hi - c_lo, start - c_lo, span)
                 if span[0] != span[1] else None)
        out.append(Piece(start - lo, stop - lo, k, share))
    return out, spans, n_chunks


_SHARE: contextvars.ContextVar[Optional[ChunkShare]] = \
    contextvars.ContextVar("chunk_share", default=None)


def current_share() -> Optional[ChunkShare]:
    """The share of the model call running now (None: a whole chunk)."""
    return _SHARE.get()


@contextlib.contextmanager
def sharing(share: Optional[ChunkShare]) -> Iterator[None]:
    """Run the block's model call as this rank's part of `share`."""
    token = _SHARE.set(share)
    try:
        yield
    finally:
        _SHARE.reset(token)
