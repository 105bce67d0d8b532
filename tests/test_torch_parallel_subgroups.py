"""Three data-parallel ranks against JAX's global routing under the
published flags (tests/test_torch_parallel_routing.py's check), where the
shared chunks span a subset of the ranks: 16 rays (64 points) a rank and a
pass, chunk 48, so [48, 96) spans ranks 0-1 and [96, 144) ranks 1-2, each
routed in a subgroup of two (switch_nerf_torch/parallel/chunks.py). And
``plan``'s arithmetic on its own: these cases, odd sizes, and the
published runs at 8 ranks, which share no chunk.
"""
import pytest

from switch_nerf_torch.parallel.chunks import RankGrid, plan
from tests.test_torch_parallel import assert_routes_as_jax
from tests.test_torch_parallel_routing import (  # noqa: F401  (fixtures)
    case_hparams, jax_checkpoint, scene)
from tests.torch_port_helpers import Ranks

WORLD, CHUNK, BATCH = 3, 48, 48


@pytest.fixture(scope="module")
def job(scene, jax_checkpoint, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("subgroups")
    return Ranks(tmp / "job.pkl", [
        {"name": "subgroups", "kind": "train", "drops": True, "record": True,
         "h": case_hparams(scene, tmp / "subgroups", jax_checkpoint, CHUNK,
                           BATCH)}], world=WORLD), tmp


def test_three_ranks_route_as_jax(job, scene, jax_checkpoint, tmp_path,
                                  monkeypatch):
    ranks, tmp = job
    outs = ranks.get("subgroups")
    assert len(outs) == WORLD
    h1, hj = (case_hparams(scene, tmp_path / n, jax_checkpoint, CHUNK, BATCH)
              for n in ("one", "jax"))
    assert_routes_as_jax(outs, tmp / "subgroups", h1, hj, monkeypatch,
                         "subgroups")


def _global_cut(points, chunk, world):
    """Every rank's pieces, as (global start, global stop, chunk, share)."""
    cut = []
    for r in range(world):
        ps, n = plan(points, chunk, RankGrid(r, world))
        cut += [(r * points + p.start, r * points + p.stop, p.chunk,
                 None if p.share is None else
                 (p.share.total, p.share.offset, p.share.ranks)) for p in ps]
    return cut, n


@pytest.mark.parametrize("points,chunk,world", [
    (128, 64, 2), (128, 96, 2), (128, 2048, 2), (64, 48, 3), (100, 7, 4),
    (5, 64, 4),
    # the published runs at 8 ranks: Building's coarse (1,024 rays x 256),
    # fine (x 512) and background (x 128, x 256) passes, Mission Bay's
    # mip passes (1,664 rays x 512 intervals); 32,768-point chunks
    (1024 * 256, 32768, 8), (1024 * 512, 32768, 8), (1024 * 128, 32768, 8),
    (1664 * 512, 32768, 8)])
def test_pieces_cut_the_global_grid(points, chunk, world):
    """The ranks' pieces tile the global points in order; each lies in one
    chunk of JAX's grid (full chunks, then the remainder); a share names
    its chunk's length, the piece's offset in it and the ranks that hold
    it. The published runs at 8 ranks share no chunk."""
    total = points * world
    c = min(chunk, total)
    cut, n = _global_cut(points, chunk, world)
    assert n == -(-total // c)
    assert [a for a, _, _, _ in cut] == [0] + [b for _, b, _, _ in cut[:-1]]
    assert cut[-1][1] == total
    for start, stop, k, share in cut:
        lo, hi = k * c, min((k + 1) * c, total)
        assert lo <= start < stop <= hi
        if share is None:
            assert (start, stop) == (lo, hi)
        else:
            assert share[0] == hi - lo and share[1] == start - lo
            assert share[2] == (lo // points, (hi - 1) // points)
    if points >= 32768:
        assert all(s is None for *_, s in cut)
