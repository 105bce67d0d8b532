"""The port's data-parallel routing against JAX's global routing, under the
published flags (capacity factor 1.0, batch-prioritized routing, l_aux
weight 5e-4), in real gloo groups (tests/torch_parallel_worker.py).

JAX cuts each pass's global point array into --model_chunk_size chunks and
routes each over its own tokens; the port's ranks cut on the same grid
(switch_nerf_torch/parallel/chunks.py). On the tiny Building config a
rank's pass holds its rays x 4 samples. After 3 steps every leaf of the
ranks' checkpoint is within 1e-5 of its largest entry of JAX's
``Runner.train`` and of the one-process port fed the same global batches,
and the ranks drop the tokens one process drops:

  * 2 ranks, 32 rays (128 points) a rank and a pass:
      - chunk 64: every chunk inside one rank (as the published Building
        and Mission Bay runs, whose passes are whole numbers of chunks);
      - chunk 96: the global 256 points in [0, 96) inside rank 0, [96,
        192) across both, and the remainder [192, 256) inside rank 1;

tests/test_torch_parallel.py holds the 2,048-point chunk that spans both
ranks whole; tests/test_torch_parallel_subgroups.py three ranks and the
chunk arithmetic.
"""
from pathlib import Path

import jax
import numpy as np
import pytest

from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu.models import model_utils as jmu
from tests.test_torch_parallel import assert_routes_as_jax, published
from tests.torch_port_helpers import (Ranks, jax_train_state,
                                      mega_train_hparams, with_val_image)

STEPS = 3
CASES = {"inside": (2, 64, 64), "mixed": (2, 96, 64)}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return with_val_image(tmp_path_factory.mktemp("mega"))


@pytest.fixture(scope="module")
def jax_checkpoint(scene, tmp_path_factory):
    h = mega_train_hparams(scene, "unused", "memory")
    state = jax_train_state(
        jax.random.PRNGKey(0), h, jmu.get_nerf(h, 6), jmu.get_bg_nerf(h, 6))
    root = tmp_path_factory.mktemp("ckpt0")
    jckpt.save_checkpoint(root, state)
    return root / "0"


def case_hparams(scene, exp, ckpt, chunk, batch):
    h = published(mega_train_hparams(scene, exp, "memory"))
    h.ckpt_path, h.train_iterations = str(ckpt), STEPS
    h.model_chunk_size, h.batch_size = chunk, batch
    return h


@pytest.fixture(scope="module")
def jobs(scene, jax_checkpoint, tmp_path_factory):
    """Each world's scenarios, started at once."""
    tmp = tmp_path_factory.mktemp("routing")
    out = {}
    for world in sorted({w for w, _, _ in CASES.values()}):
        scenarios = [
            {"name": name, "kind": "train", "drops": True, "record": True,
             "h": case_hparams(scene, tmp / name, jax_checkpoint, chunk,
                               batch)}
            for name, (w, chunk, batch) in CASES.items() if w == world]
        out[world] = Ranks(tmp / f"job{world}.pkl", scenarios, world=world)
    return out, tmp


@pytest.mark.parametrize("case", sorted(CASES))
def test_routes_as_jax(case, jobs, scene, jax_checkpoint, tmp_path,
                       monkeypatch):
    world, chunk, batch = CASES[case]
    ranks, tmp = jobs
    outs = ranks[world].get(case)
    assert len(outs) == world
    h1, hj = (case_hparams(scene, tmp_path / n, jax_checkpoint, chunk, batch)
              for n in ("one", "jax"))
    assert_routes_as_jax(outs, tmp / case, h1, hj, monkeypatch, case)
